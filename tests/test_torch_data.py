"""The port's data layer (scail_tpu_torch/data/, native/tario.py with its own
csrc/tario.cpp, utils/download.py, utils/benchmarking.py) against the JAX
package's on the CPU, on inputs made from seeds with numpy.

The JAX side runs its host helpers' numpy paths: its native libraries
(scail_tpu/native/_tario.so, _frameproc.so) are neither loaded nor built
here, so its tar index is Python's tarfile (the port's plain version) and
its frame normaliser and resize are numpy.  The port's tar index is its
g++ library, built into build/scail_tpu_torch/.  Tolerances: data, indices,
bytes and batches equal exactly; the tiny DiT's RF loss on a batch read
from shards within 2e-4 relative (the f32 CPU parity of
tests/test_torch_training.py).
"""

import io
import itertools
import json
import os
import subprocess
import sys
import tarfile
import threading
import time
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import scail_tpu.data.datasets as jds
import scail_tpu_torch.data.datasets as tds
from scail_tpu_torch.native import tario

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)


@pytest.fixture(autouse=True)
def jax_host_helpers_in_numpy(monkeypatch):
    """The JAX package's tar index through tarfile and its frame helpers in
    numpy: its native libraries stay unbuilt and unloaded."""
    import scail_tpu.native as jnative
    import scail_tpu.native.tario as jtario

    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    monkeypatch.setattr(jtario, "get_lib", lambda: None)


def _take(it, n):
    return list(itertools.islice(it, n))


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
            else:
                assert x[k] == y[k], k


# ---------------------------------------------------------------------------
# the sampler, the loaders, the mixtures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_sampler_matches_jax(shuffle, drop_last):
    for n, bs, world, start in ((11, 2, 1, 0), (11, 2, 2, 3), (11, 2, 3, 1), (7, 1, 3, 5)):
        for rank in range(world):
            args = (n, bs, rank, world, shuffle, 5, start, drop_last)
            got = _take(iter(tds.DistributedBatchSampler(*args)), 12)
            want = _take(iter(jds.DistributedBatchSampler(*args)), 12)
            assert got == want, args
            kw = dict(rank=rank, world_size=world, shuffle=shuffle, seed=5,
                      start_iter=start, drop_last=drop_last)
            assert _take(iter(tds.DistributedBatchSampler(n, bs, **kw)), 12) == want
    # a rank whose slice is shorter than a batch would wait for ever: the port raises
    with pytest.raises(ValueError, match="fewer than a batch of 3"):
        next(iter(tds.DistributedBatchSampler(10, 3, 2, 3, shuffle, 5, 0, drop_last=False)))
    with pytest.raises(ValueError, match="fewer than a batch of 3"):  # through the loader
        next(iter(tds.DataLoader(tds.TensorDictDataset(_dict_data(10)),
                                 tds.DistributedBatchSampler(10, 3, 2, 3, shuffle, 5, 0,
                                                             drop_last=False))))
    # start_iter resumes the stream exactly where it was cut
    full = _take(iter(tds.DistributedBatchSampler(9, 2, 0, 1, shuffle, 1, 0, drop_last)), 10)
    assert _take(iter(tds.DistributedBatchSampler(9, 2, 0, 1, shuffle, 1, 4, drop_last)),
                 6) == full[4:]


def _dict_data(n=10, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 3, 2)).astype(np.float32),
            "y": rng.integers(0, 9, (n,)), "w": rng.standard_normal((n,))}


def test_make_loaders_gives_jax_train_and_valid_batches():
    data, vdata = _dict_data(10, 0), _dict_data(7, 1)
    for mod in (tds, jds):
        assert mod.make_loaders(mod.TensorDictDataset(data), 2)[1] is None
    got = tds.make_loaders(tds.TensorDictDataset(data), 2, valid_ds=tds.TensorDictDataset(vdata),
                           seed=3, start_iter=1, rank=1, world_size=2)
    want = jds.make_loaders(jds.TensorDictDataset(data), 2, valid_ds=jds.TensorDictDataset(vdata),
                            seed=3, start_iter=1, rank=1, world_size=2)
    for g, w in zip(got, want):
        _assert_batches_equal(_take(iter(g), 5), _take(iter(w), 5))
    # the valid loader is in order: rank 1 of 2 takes items 3, 4, 5 of 7, in batches of 2
    first = next(iter(got[1]))
    assert np.array_equal(first["x"], vdata["x"][3:5])


class _FailsAt(jds.Dataset):
    def __init__(self, data, bad):
        self.data, self.bad = data, bad

    def __len__(self):
        return len(next(iter(self.data.values())))

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"corrupt sample {i}")
        return {k: v[i] for k, v in self.data.items()}


def test_loader_skips_a_failing_batch_like_jax(monkeypatch):
    """A batch whose item raises is skipped with the same warning in both
    loaders, and the rest of the batches are equal."""
    import scail_tpu.utils.logging as jlog

    said = {"port": [], "jax": []}
    monkeypatch.setattr(tds, "print_rank0", lambda m, level="info": said["port"].append((m, level)))
    monkeypatch.setattr(jlog, "print_rank0", lambda m, level="info": said["jax"].append((m, level)))
    data = _dict_data(6, 2)
    for shuffle in (False, True):
        del said["port"][:], said["jax"][:]
        got = _take(iter(tds.DataLoader(_FailsAt(data, 1), tds.DistributedBatchSampler(
            6, 2, shuffle=shuffle, seed=4))), 5)
        want = _take(iter(jds.DataLoader(_FailsAt(data, 1), jds.DistributedBatchSampler(
            6, 2, shuffle=shuffle, seed=4))), 5)
        _assert_batches_equal(got, want)
        assert said["port"] and said["port"] == said["jax"][:len(said["port"])]
        msg, level = said["port"][0]
        assert level == "warning" and msg.startswith("dataloader: skipping batch [") and \
            "corrupt sample 1" in msg
    # the unshuffled loader skipped batch [0, 1]: its first batch is items 2 and 3
    first = next(iter(tds.DataLoader(_FailsAt(data, 1), tds.DistributedBatchSampler(
        6, 2, shuffle=False))))
    assert np.array_equal(first["x"], data["x"][2:4])


def test_mixtures_and_plain_datasets_match_jax(tmp_path):
    a, b = _dict_data(5, 3), _dict_data(3, 4)
    for seed in (0, 7):
        got = tds.WeightedConcatDataset([tds.TensorDictDataset(a), tds.TensorDictDataset(b)],
                                        [0.3, 0.7], seed=seed)
        want = jds.WeightedConcatDataset([jds.TensorDictDataset(a), jds.TensorDictDataset(b)],
                                         [0.3, 0.7], seed=seed)
        assert len(got) == len(want) == 8
        _assert_batches_equal([got[i % 8] for i in range(20)], [want[i % 8] for i in range(20)])
    got = tds.AlterDataset([tds.TensorDictDataset(a), tds.TensorDictDataset(b)])
    want = jds.AlterDataset([jds.TensorDictDataset(a), jds.TensorDictDataset(b)])
    assert len(got) == len(want) == 8
    _assert_batches_equal([got[i] for i in range(11)], [want[i] for i in range(11)])
    rows = [{"id": i, "text": f"row {i}", "v": [i, i * 0.5]} for i in range(4)]
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows[:2]) + "\n\n" +
                    "\n".join(json.dumps(r) for r in rows[2:]) + "\n")
    fn = lambda r: dict(r, n=len(r["text"]))  # noqa: E731
    got, want = tds.JsonlDataset(str(path), fn), jds.JsonlDataset(str(path), fn)
    assert len(got) == len(want) == 4 and [got[i] for i in range(4)] == \
        [want[i] for i in range(4)]
    _assert_batches_equal([tds.default_collate([got[0], got[1]])],
                          [jds.default_collate([want[0], want[1]])])


# ---------------------------------------------------------------------------
# the native tar index
# ---------------------------------------------------------------------------
def _add(tf, name, payload):
    info = tarfile.TarInfo(name)
    info.size = len(payload)
    tf.addfile(info, io.BytesIO(payload))


def _make_shard(path, n=4, long_name=False, nested=False, odd_name=False, seed=0):
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w", format=tarfile.GNU_FORMAT) as tf:
        if nested:
            info = tarfile.TarInfo("dir")
            info.type = tarfile.DIRTYPE
            tf.addfile(info)
        for i in range(n):
            for ext in ("jpg", "txt", "ref.png"):
                name = f"{i:06d}.{ext}"
                if long_name and i == n - 1:
                    name = "deep/" * 30 + name  # past 100 bytes: a GNU long name
                if nested:
                    name = f"dir/{'ab'[i % 2]}/{name}"
                if odd_name and i == 0:
                    name = "bad\udcff" + name  # not UTF-8: surrogateescape
                _add(tf, name, rng.integers(0, 256, rng.integers(0, 2000)).astype(
                    np.uint8).tobytes())


@pytest.mark.parametrize("case", ["plain", "long_name", "nested", "odd_name"])
def test_native_index_matches_the_tarfile_index(tmp_path, case):
    shard = str(tmp_path / "s.tar")
    _make_shard(shard, **({case: True} if case != "plain" else {}))
    from scail_tpu.native.tario import _index_tarfile as jax_index_tarfile

    got = tario.index_tar(shard)
    assert got == tario._index_tarfile(shard) == jax_index_tarfile(shard)
    assert len(got) == 12 and tario.get_lib() is not None
    with tarfile.open(shard) as tf:
        payloads = {m.name: tf.extractfile(m).read() for m in tf.getmembers() if m.isfile()}
    for name, off, size in got:
        assert tario.read_member(shard, off, size) == payloads[name]


def test_native_index_grows_its_buffers_and_raises_on_a_truncated_shard(tmp_path, monkeypatch):
    shard = tmp_path / "s.tar"
    _make_shard(str(shard), n=6, long_name=True)
    want = tario._index_tarfile(str(shard))
    monkeypatch.setattr(tario, "MAX_ENTRIES", 2)  # -2: grown 4x, twice
    assert tario.index_tar(str(shard)) == want
    monkeypatch.setattr(tario, "MAX_ENTRIES", 1 << 16)
    monkeypatch.setattr(tario, "NAMES_CAP", 64)  # the long name needs more
    assert tario.index_tar(str(shard)) == want
    with tarfile.open(shard) as tf:
        last = tf.getmembers()[-1]
    (tmp_path / "cut.tar").write_bytes(shard.read_bytes()[:last.offset_data + last.size // 2])
    with pytest.raises(OSError, match="truncated or corrupt"):
        tario.index_tar(str(tmp_path / "cut.tar"))
    with pytest.raises(tarfile.ReadError):  # where the plain version raises too
        tario._index_tarfile(str(tmp_path / "cut.tar"))
    with pytest.raises(OSError, match="short read"):
        tario.read_member(str(tmp_path / "cut.tar"), last.offset_data, last.size)


def test_native_build_writes_only_into_its_build_dir(tmp_path):
    """A fresh interpreter builds the library into an empty build dir and
    indexes a shard, under an audit hook: the one compile reads the port's
    source and writes into the build dir, no file under scail_tpu/ is opened
    for writing, and the loaded library is the port's, not the JAX package's
    _tario.so."""
    shard = str(tmp_path / "s.tar")
    _make_shard(shard, n=2)
    build = str(tmp_path / "build")
    code = (
        "import json, os, sys\n"
        "writes, cmds = [], []\n"
        "W = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND | os.O_TRUNC\n"
        "def hook(event, args):\n"
        "    if event == 'open':\n"
        "        path, mode, flags = args\n"
        "        if (mode and any(c in mode for c in 'wax+')) or (mode is None and flags & W):\n"
        "            writes.append(os.path.abspath(str(path)))\n"
        "    elif event == 'subprocess.Popen':\n"
        "        cmds.append([str(a) for a in args[1]])\n"
        "sys.addaudithook(hook)\n"
        "from pathlib import Path\n"
        "import scail_tpu_torch.native.tario as tario\n"
        f"tario.BUILD_DIR = Path({build!r})\n"
        f"n = len(tario.index_tar({shard!r}))\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(json.dumps({'n': n, 'writes': writes, 'cmds': cmds, 'info': tario.BUILD_INFO,\n"
        "                  'tario_libs': sorted({l.split()[-1] for l in maps.splitlines()\n"
        "                                        if 'tario' in l})}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    jax_pkg = os.path.join(ROOT, "scail_tpu") + os.sep
    assert rec["n"] == 6 and rec["info"]["cached"] is False
    assert rec["tario_libs"] == [rec["info"]["path"]]
    assert os.path.dirname(rec["info"]["path"]) == build
    assert os.path.basename(rec["info"]["path"]).startswith("libscail_tario_")
    (cmd,) = rec["cmds"]
    assert cmd[0] == "g++" and cmd[-2] == "-o" and os.path.dirname(cmd[-1]) == build
    assert str(tario.SOURCE) in cmd and str(tario.SOURCE).startswith(
        os.path.join(ROOT, "scail_tpu_torch", "csrc"))
    assert not [a for a in cmd if a.startswith(jax_pkg)]
    assert not [w for w in rec["writes"] if w.startswith(jax_pkg)], rec["writes"]
    # the default build dir is the repository's build/scail_tpu_torch
    assert tario.BUILD_DIR == tario.Path(ROOT) / "build" / "scail_tpu_torch"


# ---------------------------------------------------------------------------
# tar shard datasets
# ---------------------------------------------------------------------------
def _samples_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y) and all(bytes(x[k]) == bytes(y[k]) if k != "__key__"
                                        else x[k] == y[k] for k in x)


def test_tar_shard_paths_match_jax(tmp_path):
    """The local path (the port's native index, the JAX package's tarfile
    index), the pipe: stream in both packages, and nested names: one set of
    samples; the shard order and the rank split equal JAX's."""
    shards = []
    for i, nested in enumerate((False, True)):
        shards.append(str(tmp_path / f"shard-{i:03d}.tar"))
        _make_shard(shards[-1], n=3, nested=nested, seed=i)
    for shard in shards:
        want = _take(iter(jds.TarShardDataset([shard], shuffle_shards=False)), 3)
        for source in (shard, f"pipe:cat {shard}"):
            _samples_equal(_take(iter(tds.TarShardDataset([source], shuffle_shards=False)), 3),
                           want)
        _samples_equal(_take(iter(jds.TarShardDataset([f"pipe:cat {shard}"],
                                                       shuffle_shards=False)), 3), want)
    assert [s["__key__"] for s in _take(iter(tds.TarShardDataset(shards[1:], shuffle_shards=False)),
                                        3)] == ["dir/a/000000", "dir/b/000001", "dir/a/000002"]
    # six samples over two shards, cycled: the stream wraps to the first shard
    got = _take(iter(tds.TarShardDataset(shards, shuffle_shards=False)), 8)
    _samples_equal(got, _take(iter(jds.TarShardDataset(shards, shuffle_shards=False)), 8))
    assert got[6]["__key__"] == "000000"
    many = [f"s-{i:03d}.tar" for i in range(7)]
    for rank, world, seed in ((0, 1, 0), (1, 3, 5), (2, 3, 5), (0, 2, 9)):
        assert tds.TarShardDataset(many, rank=rank, world_size=world, seed=seed).shards == \
            jds.TarShardDataset(many, rank=rank, world_size=world, seed=seed).shards


def test_tar_shard_errors_and_abandon(tmp_path):
    """A shard cut short raises in the consumer; an iterator abandoned
    mid-shard leaves no reader thread alive."""
    shard = tmp_path / "s.tar"
    with tarfile.open(shard, "w") as tf:
        for i in range(32):  # far more than the reader's queue holds
            _add(tf, f"{i:06d}.bin", bytes(64))
    before = set(threading.enumerate())
    it = iter(tds.TarShardDataset([str(shard)], shuffle_shards=False))
    next(it)
    readers = [t for t in threading.enumerate() if t not in before]
    assert len(readers) == 1 and readers[0].is_alive()  # it waits on its full queue
    it.close()
    readers[0].join(timeout=5.0)
    assert not readers[0].is_alive()
    ds = tds.TarShardDataset([str(shard)], shuffle_shards=False)
    idx = tario.TarShardIndex(str(shard))  # indexed while whole
    with open(shard, "r+b") as f:
        f.truncate(4096 + 700)  # inside the fifth member's block
    ds._index_cache = {str(shard): idx}
    with pytest.raises(OSError, match="short read"):
        for _ in ds:
            pass
    with pytest.raises(OSError, match="truncated or corrupt"):
        next(iter(tds.TarShardDataset([str(shard)], shuffle_shards=False)))


def test_train_cli_evaluates_its_valid_loader(tmp_path, monkeypatch):
    """--valid-data-root: the train CLI hands make_loaders' valid loader to
    Trainer.fit, which evaluates it with the training loss (eval_interval
    1, eval_iters 1 here) on the valid examples in order."""
    import functools

    import scail_tpu_torch.engine as engine_mod
    import scail_tpu_torch.training.engine as tengine
    from scail_tpu_torch.cli import train
    from test_torch_training import _make_data_root, _toy_engine, _toy_train_yaml

    monkeypatch.setattr(engine_mod, "VideoDiffusionEngine",
                        _toy_engine(engine_mod.VideoDiffusionEngine))
    monkeypatch.setattr(tengine, "TrainConfig", functools.partial(
        tengine.TrainConfig, eval_interval=1, eval_iters=1))
    loads, evals = [], []
    getitem, evaluate = tds.VideoPoseDataset.__getitem__, tengine.Trainer.evaluate
    monkeypatch.setattr(tds.VideoPoseDataset, "__getitem__",
                        lambda self, i: loads.append((os.path.basename(self.root), i))
                        or getitem(self, i))
    monkeypatch.setattr(tengine.Trainer, "evaluate",
                        lambda self, it, fn: evals.append(evaluate(self, it, fn)) or evals[-1])
    root = _make_data_root(str(tmp_path / "train"))
    valid = _make_data_root(str(tmp_path / "valid"), n_examples=3, seed=1)
    t = train.main(["--base", _toy_train_yaml(tmp_path), "--data-root", root,
                    "--valid-data-root", valid, "--image-size", "32", "32", "--num-frames", "5",
                    "--warmup-iters", "1", "--train-iters", "2", "--device", "cpu"])
    assert t.step == 2 and all(m["ok"] for m in t.history)
    assert len(evals) == 2 and np.isfinite(evals).all()
    assert [i for r, i in loads if r == "valid"][:2] == [0, 1]
    one = _make_data_root(str(tmp_path / "valid1"), n_examples=1, seed=2)
    with pytest.raises(SystemExit, match="validation set too small"):
        train.main(["--base", _toy_train_yaml(tmp_path), "--data-root", root,
                    "--valid-data-root", one, "--batch-size", "2", "--device", "cpu"])


def _caption_shard(path, n):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            _add(tf, f"{i:06d}.txt", f"caption {i}".encode())


def test_meta_tar_shard_dataset_matches_jax(tmp_path):
    p = tmp_path / "clips.v2-000.tar"
    _caption_shard(p, 4)
    for mod in (tds, jds):
        assert mod.MetaTarShardDataset.meta_path_for(str(p)) == str(
            tmp_path / "clips.v2-000.meta.jsonl")
    with open(tmp_path / "clips.v2-000.meta.jsonl", "w") as f:
        f.write(json.dumps({"key": "000000", "score": 0.5, "other": "x"}) + "\n")
        f.write("NOT JSON {{{\n")
        f.write(json.dumps({"score": 0.1}) + "\n")  # no key
        f.write("42\n")  # no object
        f.write(json.dumps({"key": "000002", "score": 0.9, "caption": "a dancer"}) + "\n")
    p2 = tmp_path / "plain-001.tar"  # no sidecar
    _caption_shard(p2, 1)
    for names in (["score"], ["score", "caption"], []):
        for shards in ([str(p)], [f"pipe:cat {p}"], [str(p2)]):
            got = _take(iter(tds.MetaTarShardDataset(shards, meta_names=names,
                                                     shuffle_shards=False)), 4)
            want = _take(iter(jds.MetaTarShardDataset(shards, meta_names=names,
                                                      shuffle_shards=False)), 4)
            assert [{k: bytes(v) if isinstance(v, bytearray) else v for k, v in s.items()}
                    for s in got] == want
    got = _take(iter(tds.MetaTarShardDataset([str(p)], meta_names=["score"],
                                             shuffle_shards=False)), 4)
    assert [s.get("score") for s in got] == [0.5, None, 0.9, None] and "other" not in got[0]


def test_braceexpand_and_expand_shard_paths_match_jax(tmp_path):
    for pattern in ("s-{000..002}.tar", "{a,b}/{0..1}.tar", "plain.tar", "x{8..11}",
                    "x{08..11}-{a,{b,c}}", "{1..3}{,.v2}.tar"):
        assert tds.braceexpand(pattern) == jds.braceexpand(pattern)
    assert tds.braceexpand("s-{000..002}.tar") == ["s-000.tar", "s-001.tar", "s-002.tar"]
    for d in ("A", "B", "C/deep"):
        os.makedirs(tmp_path / d)
    _caption_shard(tmp_path / "A" / "a0.tar", 1)
    _caption_shard(tmp_path / "B" / "b1.tar", 1)
    _caption_shard(tmp_path / "B" / "b0.tar", 1)
    _caption_shard(tmp_path / "C" / "deep" / "c0.tar", 1)
    (tmp_path / "B" / "empty.tar").write_bytes(b"")
    (tmp_path / "A" / "avatar").write_bytes(b"not a tar")
    for path, dirs in (("", f"{tmp_path}/A,{tmp_path}/B*2"), (f"{tmp_path}/A/a{{0..1}}.tar",
                                                              f"{tmp_path}/C"),
                       ("", f"{tmp_path}*3"), (f"{tmp_path}/x.tar", None)):
        assert tds.expand_shard_paths(path, dirs) == jds.expand_shard_paths(path, dirs)
    assert tds.expand_shard_paths("", f"{tmp_path}/B*2") == [
        str(tmp_path / "B" / "b0.tar"), str(tmp_path / "B" / "b1.tar")] * 2


def test_gopen_matches_jax(tmp_path):
    from scail_tpu.data import gopen as jgopen
    from scail_tpu_torch.data import gopen as tgopen

    p = tmp_path / "blob.bin"
    p.write_bytes(bytes(range(256)) * 64)
    for url in (str(p), f"file://{p}", f"pipe:cat {p}", f"pipe:head -c 100 {p}"):
        with tgopen.gopen(url) as f, jgopen.gopen(url) as g:
            assert f.read() == g.read()
    with pytest.raises(ValueError, match="unknown url scheme"):
        tgopen.gopen("gs://bucket/x.tar")
    with pytest.raises(OSError, match="status 3"):
        tgopen.Pipe("exit 3").close()
    tgopen.Pipe("exit 141").close()  # SIGPIPE-style statuses are ignored
    opened = []
    tgopen.register_scheme("mem", lambda url, bufsize: opened.append(url) or io.BytesIO(b"m"))
    assert tgopen.gopen("mem://x").read() == b"m" and opened == ["mem://x"]
    # a failing pipe surfaces its status when the shard stream closes
    with pytest.raises(OSError, match="exited with status 1"):
        _take(iter(tds.TarShardDataset([f"pipe:cat {p}.missing"], shuffle_shards=False)), 1)


# ---------------------------------------------------------------------------
# demo datasets, HF datasets, downloads, the calibration probe
# ---------------------------------------------------------------------------
def _write_idx(path, arr, compress=False):
    import gzip
    import struct

    payload = struct.pack(">HBB", 0, 0x08, arr.ndim)
    payload += struct.pack(">" + "I" * arr.ndim, *arr.shape) + arr.astype(np.uint8).tobytes()
    with (gzip.open(path + ".gz", "wb") if compress else open(path, "wb")) as f:
        f.write(payload)


def test_demo_datasets_match_jax(tmp_path):
    import pickle

    import scail_tpu.data.demo as jdemo
    import scail_tpu_torch.data.demo as tdemo

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (3, 5, 4), np.uint8)
    for gz in (False, True):
        _write_idx(str(tmp_path / f"a{gz}-idx3-ubyte"), arr, gz)
        got = tdemo.read_idx(str(tmp_path / f"a{gz}-idx3-ubyte"))
        assert np.array_equal(got, arr) and np.array_equal(
            got, jdemo.read_idx(str(tmp_path / f"a{gz}-idx3-ubyte")))
    (tmp_path / "bad-idx").write_bytes(b"\x00\x00\x0d\x01\x00\x00\x00\x01x")
    with pytest.raises(ValueError, match="not a ubyte IDX"):
        tdemo.read_idx(str(tmp_path / "bad-idx"))
    # MNIST in the flat layout (gzipped) and under MNIST/raw (dotted names)
    flat, nested = tmp_path / "flat", tmp_path / "nested" / "MNIST" / "raw"
    os.makedirs(flat)
    os.makedirs(nested)
    for stem, k in (("train", 6), ("t10k", 4)):
        imgs, labels = rng.integers(0, 256, (k, 28, 28), np.uint8), rng.integers(0, 10, k)
        _write_idx(str(flat / f"{stem}-images-idx3-ubyte"), imgs, True)
        _write_idx(str(flat / f"{stem}-labels-idx1-ubyte"), labels, True)
        _write_idx(str(nested / f"{stem}-images.idx3-ubyte"), imgs)
        _write_idx(str(nested / f"{stem}-labels.idx1-ubyte"), labels)
    cifar = tmp_path / "cifar" / "cifar-10-batches-py"
    os.makedirs(cifar)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072), np.uint8),
                         b"labels": rng.integers(0, 10, 3).tolist()}, f)
    for root in (flat, tmp_path / "nested"):
        for train in (True, False):
            g, w = tdemo.load_mnist(str(root), train), jdemo.load_mnist(str(root), train)
            assert g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in g)
    for train in (True, False):
        g, w = tdemo.load_cifar10(str(tmp_path / "cifar"), train), \
            jdemo.load_cifar10(str(tmp_path / "cifar"), train)
        assert all(np.array_equal(g[k], w[k]) and g[k].dtype == w[k].dtype for k in g)
    cases = [("MNISTDemo", dict(root=str(flat))),
             ("CIFAR10Demo", dict(root=str(tmp_path / "cifar"))),
             ("MNISTDemo", dict(synthetic=True, synthetic_n=9, seed=3)),
             ("CIFAR10Demo", dict(synthetic=True, synthetic_n=5, seed=1))]
    for cls, kw in cases:
        for train in (True, False):
            g, w = getattr(tdemo, cls)(train=train, **kw), getattr(jdemo, cls)(train=train, **kw)
            assert len(g) == len(w)
            _assert_batches_equal([g[i] for i in range(len(g))], [w[i] for i in range(len(w))])
            rec = g[0]
            assert rec["jpg"].dtype == np.float32 and isinstance(rec["cls"], int)
            assert -1.0 <= rec["jpg"].min() and rec["jpg"].max() <= 1.0
    with pytest.raises(FileNotFoundError, match="MNIST IDX files not found"):
        tdemo.MNISTDemo(root=str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError, match="data_batch_1 missing"):
        tdemo.CIFAR10Demo(root=str(tmp_path / "nothing"))
    for name in ("mnist", "cifar10"):
        kw = dict(dataset=name, batch_size=2, synthetic=True, seed=2, rank=1, world_size=2)
        g, w = tdemo.DemoImageLoader(**kw), jdemo.DemoImageLoader(**kw)
        for fn in ("train_dataloader", "test_dataloader", "val_dataloader"):
            _assert_batches_equal(_take(iter(getattr(g, fn)()), 3),
                                  _take(iter(getattr(w, fn)()), 3))
        _assert_batches_equal(_take(iter(g.val_dataloader()), 2),
                              _take(iter(g.test_dataloader()), 2))


@pytest.fixture()
def no_network(monkeypatch):
    """Every socket connect and name lookup of this process raises before it
    leaves the process; the attempts are recorded."""
    import socket

    attempts = []

    def refuse(*a, **kw):
        attempts.append(repr(a[:2]))
        raise OSError("the network is out of this test's reach")

    for owner, name in ((socket, "getaddrinfo"), (socket, "create_connection"),
                        (socket.socket, "connect"), (socket.socket, "connect_ex")):
        monkeypatch.setattr(owner, name, refuse)
    return attempts


def test_hf_dataset_processed_cache_offline_matches_jax(tmp_path, monkeypatch, no_network):
    """The processed-cache branch loads offline; offline, a dataset missing
    from every cache raises without a lookup or a connection (the JAX
    package's offline switch leaves the hub's own on, so its load would
    reach for the hub)."""
    datasets = pytest.importorskip("datasets")
    import huggingface_hub.constants

    from scail_tpu.data import hf_dataset as jhf
    from scail_tpu_torch.data import hf_dataset as thf

    for path in ("hf://glue/mrpc/test", "glue/*/validation", "wikitext", "hf://a/b"):
        assert thf.parse_huggingface_path(path) == jhf.parse_huggingface_path(path)
    assert thf.parse_huggingface_path("glue/*/validation") == ("glue", None, "validation")
    for var in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE"):
        monkeypatch.setenv(var, "0")
    monkeypatch.setattr(datasets.config, "HF_DATASETS_OFFLINE", False)
    monkeypatch.setattr(datasets.config, "HF_HUB_OFFLINE", False)
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", False)
    cache = tmp_path / "hfcache"
    cache.mkdir()
    datasets.Dataset.from_dict({"ids": [[1, 2], [3, 4], [5, 6]], "y": [0, 1, 1]}).save_to_disk(
        str(cache / "fake_sub_train_tok.data"))
    kw = dict(columns=["ids"], cache_dir=str(cache), transformer_name="tok")
    want = jhf.load_hf_dataset("hf://fake/sub/train", None, **kw)
    got = thf.load_hf_dataset("hf://fake/sub/train", None, offline=True, **kw)
    assert os.environ["HF_HUB_OFFLINE"] == "1" and datasets.config.HF_HUB_OFFLINE and \
        huggingface_hub.constants.HF_HUB_OFFLINE
    assert len(got) == len(want) == 3
    for i in range(3):
        assert list(got[i]) == ["ids"] and np.array_equal(got[i]["ids"], want[i]["ids"])
    with pytest.raises(ConnectionError, match="OfflineModeIsEnabled"):
        thf.load_hf_dataset("hf://fake/other/train", None, offline=True, **kw)
    assert no_network == []


class _RangeHandler(BaseHTTPRequestHandler):
    """Serves self.server.payload, honouring Range unless server.no_range."""

    def log_message(self, *a):
        pass

    def do_GET(self):
        data, rng = self.server.payload, self.headers.get("Range")
        self.server.ranges.append(rng)
        if rng and not self.server.no_range:
            start = int(rng.split("=")[1].rstrip("-"))
            if start >= len(data):
                self.send_response(416)
                self.end_headers()
                return
            body = data[start:]
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {start}-{len(data) - 1}/{len(data)}")
        else:
            body = data
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture()
def http_server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _RangeHandler)
    srv.payload, srv.ranges, srv.no_range = b"", [], False
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()
    srv.server_close()


def test_download_resumes_restarts_and_auto_creates(tmp_path, http_server):
    pytest.importorskip("requests")
    from scail_tpu.utils import download as jdl
    from scail_tpu_torch.utils import download as tdl

    assert tdl.MODEL_URLS == jdl.MODEL_URLS
    url = f"http://127.0.0.1:{http_server.server_address[1]}/blob.bin"
    data = np.random.default_rng(0).integers(0, 256, 70000, np.uint8).tobytes()
    http_server.payload = data
    dst = tmp_path / "blob.bin"
    dst.write_bytes(data[:30000])  # a torn download resumes with a Range request
    tdl.download_with_progress_bar(str(dst), url, show_progress=False)
    assert dst.read_bytes() == data and http_server.ranges == ["bytes=30000-"]
    tdl.download_with_progress_bar(str(dst), url, show_progress=False)  # 416: complete
    assert dst.read_bytes() == data
    http_server.no_range = True  # a server that ignores Range: restart from zero
    dst.write_bytes(data[:999])
    tdl.download_with_progress_bar(str(dst), url, show_progress=False)
    assert dst.read_bytes() == data
    http_server.no_range = False
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("tiny-model/weights.bin", data[:5000])
        z.writestr("tiny-model/config.json", "{}")
    http_server.payload = buf.getvalue()
    zurl = f"http://127.0.0.1:{http_server.server_address[1]}/tiny-model.zip"
    home = tmp_path / "home"
    got = tdl.auto_create("tiny-model", path=str(home), url=zurl, show_progress=False)
    assert got == str(home / "tiny-model") and (home / "tiny-model" / "weights.bin").read_bytes() \
        == data[:5000]
    http_server.payload = b"garbage that a second fetch would unzip"
    assert tdl.auto_create("tiny-model", path=str(home), url=zurl, show_progress=False) == got
    assert tdl.auto_create("x", path=str(home), url="local") == str(home / "x")
    with pytest.raises(KeyError, match="scail_tpu_torch.utils.download.MODEL_URLS"):
        tdl.auto_create("not-a-known-model", path=str(home))
    with pytest.raises(RuntimeError, match="r2 bucket"):
        tdl.auto_create("chatglm-6b", path=str(home), url="r2://chatglm-6b.zip")
    for env, want in (({"SCAIL_HOME": "/s", "SAT_HOME": "/t"}, "/s"), ({"SAT_HOME": "/t"}, "/t"),
                      ({}, os.path.expanduser("~/.scail_models"))):
        old = {k: os.environ.pop(k, None) for k in ("SCAIL_HOME", "SAT_HOME")}
        try:
            os.environ.update(env)
            assert tdl._home(None) == jdl._home(None) == want
        finally:
            for k, v in old.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v


# ---------------------------------------------------------------------------
# the slice: example shards -> both packages' loaders -> the tiny DiT's loss
# ---------------------------------------------------------------------------
def _examples(root, n=2, frames=4, hw=(16, 16), seed=0):
    """n example dirs of .npz clips and a PNG reference, from a seed."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    dirs = []
    for i in range(n):
        d = os.path.join(root, f"{i:03d}")
        os.makedirs(d)
        for name in ("driving", "rendered"):
            np.savez(os.path.join(d, f"{name}.npz"),
                     frames=rng.integers(0, 256, (frames, *hw, 3), np.uint8))
        Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(os.path.join(d, "ref.png"))
        dirs.append(d)
    return dirs


def _shard_examples(dirs, shard):
    with tarfile.open(shard, "w") as tf:
        for d in dirs:
            key = os.path.basename(d)
            for name in ("driving.npz", "rendered.npz", "ref.png"):
                with open(os.path.join(d, name), "rb") as f:
                    _add(tf, f"{key}.{name}", f.read())
            _add(tf, f"{key}.txt", f"clip {key}".encode())


def _jax_video_pose_sample(tmp_root, image_size, num_frames):
    """The JAX package's process_fn for such a sample: its VideoPoseDataset on
    a directory holding the members, the caption or txt as text."""
    def fn(sample):
        d = os.path.join(tmp_root, sample["__key__"])
        os.makedirs(os.path.join(d, "ex"), exist_ok=True)
        for ext, payload in sample.items():
            if ext.endswith((".npz", ".png", ".mp4", ".jpg")):
                with open(os.path.join(d, "ex", ext), "wb") as f:
                    f.write(bytes(payload))
        item = jds.VideoPoseDataset(d, image_size, num_frames)[0]
        item["txt"] = sample.get("caption", bytes(sample.get("txt", b"")).decode())
        return item
    return fn


def _loss_case(batch, T=3):
    """The tiny DiT's loss inputs (tests/test_torch_training.py `_case`
    layout) made from a collated batch by a fixed numpy map: the clip,
    the reference and the first frame space-to-depth into latent channels,
    the pose at half the latent size, the text from the caption's bytes."""
    from test_torch_training import TINY, _case

    def s2d(x, f):
        b, t, c, h, w = x.shape
        x = x.reshape(b, t, c, h // f, f, w // f, f).transpose(0, 1, 2, 4, 6, 3, 5)
        return x.reshape(b, t, c * f * f, h // f, w // f)

    case = _case(seed=5, b=len(batch["txt"]), T=T, H=8, W=8)
    x = s2d(batch["mp4"][:, :T], 2)
    case["latents"] = np.concatenate([x, x[:, :, :4]], axis=2)
    r = s2d(batch["ref_frame"], 2)
    case["cond"]["ref_concat"] = np.concatenate([r, r[:, :, :4]], axis=2)
    case["cond"]["concat_smpl_render"] = s2d(batch["pose"][:, :T], 4)[:, :, :16]
    case["cond"]["image_clip_features"] = batch["first_frame"].reshape(
        len(batch["txt"]), -1)[:, :5 * TINY["clip_dim"]].reshape(-1, 5, TINY["clip_dim"])
    text = np.stack([np.frombuffer(t.encode().ljust(96)[:96], np.uint8) for t in batch["txt"]])
    case["cond"]["crossattn"] = (text.astype(np.float32) / 127.5 - 1.0).reshape(
        -1, 6, TINY["text_dim"])
    return case


def test_shards_to_batches_to_the_dit_loss_match_jax(tmp_path):
    """Example dirs in two tar shards with a sidecar caption go through both
    packages' MetaTarShardDataset (the port's native index; JAX's tarfile
    index) with each package's own video helpers: each sample equals the
    VideoPoseDataset item of its dir, first_frame included; the collated
    batches are equal; the tiny DiT's RF loss on them through the port
    equals JAX's (rtol 2e-4)."""
    import jax

    from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
    from scail_tpu.models.dit import dit_forward, init_dit_params
    from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax
    from scail_tpu_torch.models.dit import DiT, DiTConfig
    from test_torch_training import TINY, _jax_rf_loss, _port_rf_loss

    dirs = _examples(str(tmp_path / "examples"), n=3, frames=4)
    size, frames = (16, 16), 5  # the clips are padded from 4 to 5 frames
    _shard_examples(dirs[:2], str(tmp_path / "shards-000.tar"))
    _shard_examples(dirs[2:], str(tmp_path / "shards-001.tar"))
    with open(tmp_path / "shards-000.meta.jsonl", "w") as f:
        f.write(json.dumps({"key": "001", "caption": "a dancer spins"}) + "\n")
        f.write("{not json\n")
    shards = tds.expand_shard_paths(str(tmp_path / "shards-{000..001}.tar"))
    assert shards == jds.expand_shard_paths(str(tmp_path / "shards-{000..001}.tar"))
    port = tds.MetaTarShardDataset(shards, tds.VideoPoseSample(size, frames),
                                   meta_names=["caption"], shuffle_shards=False)
    ref = jds.MetaTarShardDataset(shards, _jax_video_pose_sample(str(tmp_path / "jax"), size,
                                                                 frames),
                                  meta_names=["caption"], shuffle_shards=False)
    got, want = _take(iter(port), 3), _take(iter(ref), 3)
    _assert_batches_equal(got, want)
    items = tds.VideoPoseDataset(str(tmp_path / "examples"), size, frames)
    jitems = jds.VideoPoseDataset(str(tmp_path / "examples"), size, frames)
    for i, sample in enumerate(got):
        item, jitem = items[i], jitems[i]
        assert sample["txt"] == ("a dancer spins" if i == 1 else f"clip {i:03d}")
        assert item["first_frame"].shape == (1, 3, 16, 16)
        _assert_batches_equal([dict(sample, txt="")], [item])
        _assert_batches_equal([item], [jitem])
    batch, jbatch = tds.default_collate(got[:2]), jds.default_collate(want[:2])
    _assert_batches_equal([batch], [jbatch])
    assert batch["mp4"].shape == (2, 5, 3, 16, 16) and batch["txt"] == ["clip 000",
                                                                       "a dancer spins"]

    # jitted whole: op by op, JAX compiles each of a few hundred ops alone
    params = jax.jit(lambda k: init_dit_params(k, JaxDiTConfig(**TINY)))(jax.random.PRNGKey(0))
    jcfg = JaxDiTConfig(**TINY, attn_impl="xla")
    jcase = _loss_case(jbatch)

    def jax_loss(p):
        def jnet(x, c_noise, cond, **kw):
            return dit_forward(p, jcfg, x, c_noise, cond["crossattn"],
                               ref_concat=cond["ref_concat"],
                               concat_smpl_render=cond["concat_smpl_render"],
                               image_clip_features=cond["image_clip_features"],
                               history_mask=kw.get("history_mask"))
        return _jax_rf_loss(jcase, jnet)

    want_loss = np.asarray(jax.jit(jax_loss)(params))
    model = DiT(DiTConfig(**TINY))
    model.load_state_dict(dit_state_dict_from_jax(params))

    def net(x, c_noise, cond, **kw):
        return model(x, c_noise, cond["crossattn"], ref_concat=cond["ref_concat"],
                     concat_smpl_render=cond["concat_smpl_render"],
                     image_clip_features=cond["image_clip_features"],
                     history_mask=kw.get("history_mask"))

    import torch

    with torch.no_grad():
        got_loss = _port_rf_loss(_loss_case(batch), net).numpy()
    assert got_loss.shape == want_loss.shape == (2,) and np.isfinite(got_loss).all()
    np.testing.assert_allclose(got_loss, want_loss, rtol=2e-4)


def test_new_modules_and_the_calibration_probe_import_no_jax():
    """Each new module, imported in a fresh interpreter, and the calibration
    probe run there on the CPU (n 64, chain 2: its two keys, its share of
    the H100's 989 TFLOP/s), leave no module of jax or scail_tpu behind
    (the package-wide guards are in tests/test_torch_sampling.py)."""
    mods = ["scail_tpu_torch.data.datasets", "scail_tpu_torch.data.gopen",
            "scail_tpu_torch.data.demo", "scail_tpu_torch.data.hf_dataset",
            "scail_tpu_torch.native.tario", "scail_tpu_torch.utils.download",
            "scail_tpu_torch.utils.benchmarking"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from scail_tpu_torch.utils.benchmarking import PEAK_TFLOPS, calibration_probe\n"
            "r = calibration_probe(n=64, chain=2, device='cpu')\n"
            "assert sorted(r) == ['probe_frac_of_peak', 'probe_matmul_tflops'], r\n"
            "assert r['probe_matmul_tflops'] >= 0 and PEAK_TFLOPS == 989.0\n"
            "assert abs(r['probe_frac_of_peak'] - r['probe_matmul_tflops'] / 989.0) < 1e-3\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'scail_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]
