"""The port's parallel paths (scail_tpu_torch/parallel/, the DiT under a mesh)
against the JAX package, on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices of
tests/conftest.py.  The port side runs in real torch.distributed worlds of
gloo processes on the CPU (world 4 and world 8), each started once per file
by a module fixture that runs every case and returns what each rank
computed; each test reads its case.  The workers are this module's `_w_*`
functions: the spawned ranks import this file, which therefore imports no
jax at its top.  Weights and inputs are numpy arrays made from seeds, the
DiT's bridged from JAX init_dit_params by convert/from_jax.py.

Tolerances (f32): Ulysses and ring attention, forward and gradients, 2e-4;
the DiT under a mesh 5e-4 (the JAX package's own bound for its sharded
forward, tests/test_parallel.py); vocab-parallel cross entropy 2e-5;
h_shift / w_shift 1e-4.  The sliding-tile DiT under a mesh runs a window that
covers every tile, which equals dense attention: it is held against JAX's
dense forward, as the JAX package's own STA mesh tests hold JAX's.
"""

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
SPAWN_TIMEOUT_S = 120

TINY = dict(hidden_size=32, num_layers=2, num_heads=4, inner_hidden_size=48,
            time_embed_dim=32, text_dim=16, clip_dim=8, share_adaln=True,
            use_i2v_clip=True, dtype="float32", interleaved_rope=True)
TINY2 = dict(TINY, num_heads=2)  # the JAX package's sharded-forward test config
STA = dict(attn_impl="sta", sta_tile=(1, 2), sta_window=(2, 2))  # covers every tile


# --------------------------------------------------------------------------
# Spawning worlds of gloo ranks
# --------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_world(module: str, worker: str, world: int, workdir: str):
    """Start `module.worker(inputs)` in `world` gloo ranks on the CPU, on the
    inputs saved in `workdir`; returns the processes (collect_world waits
    for them)."""
    port = _free_port()
    code = (f"import sys; sys.path.insert(0, {TESTS!r}); sys.path.insert(0, {ROOT!r}); "
            f"import test_torch_parallel as p, {module} as m; p._rank_main(m.{worker})")
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), WORKDIR=workdir,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    return procs


def collect_world(procs, workdir: str, timeout: float = SPAWN_TIMEOUT_S):
    """Each rank's results (the dict it saved).  Ranks that outlive
    `timeout` are killed, and a failure shows every failed rank's stderr."""
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        errs = [p.communicate()[1] for p in procs]
        raise AssertionError(f"a rank outlived {timeout} s; stderr:\n" + "\n".join(
            f"--- rank {r}\n{e[-3000:]}" for r, e in enumerate(errs)))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "ranks failed: " + "\n".join(
        f"--- rank {r} (exit {procs[r].returncode})\n{errs[r][-4000:]}" for r in bad)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def _rank_main(worker):
    """A spawned rank: gloo from the environment, the worker's cases, the
    results saved for the fixture."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from scail_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed(device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    workdir = os.environ["WORKDIR"]
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    results = worker(inputs)
    torch.save(results, os.path.join(workdir, f"rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rows(x, mesh, dim):
    """This rank's seq rows of a full tensor."""
    from scail_tpu_torch.parallel import comm
    from scail_tpu_torch.parallel.mesh import SEQ_AXIS

    return comm.local_slice(x, mesh, SEQ_AXIS, dim)


def _batch(mesh, b):
    d, n = mesh.rank("data"), mesh.size("data")
    return slice(d * b // n, (d + 1) * b // n)


# --------------------------------------------------------------------------
# Port-side workers
# --------------------------------------------------------------------------
def _attention_case(spec, fn, inp):
    """fn(q, k, v, mesh) on this rank's rows (its data slice of the batch),
    and the gradients of sum(out * dO)."""
    from scail_tpu_torch.parallel import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(*spec))
    bs = _batch(mesh, inp["q"].shape[0])
    q, k, v, do = (_rows(_t(inp[n])[bs], mesh, 1).clone() for n in ("q", "k", "v", "do"))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = fn(q, k, v, mesh)
    (out * do).sum().backward()
    return dict(coords=mesh.coords, out=out.detach(), dq=q.grad, dk=k.grad, dv=v.grad)


def _dit_case(inp, cfg_kw, spec, sd_key):
    """The DiT under a mesh on this data rank's batch; returns its output."""
    from scail_tpu_torch.models.dit import DiT, DiTConfig
    from scail_tpu_torch.parallel import MeshSpec, make_mesh
    from scail_tpu_torch.parallel.sharding import dit_param_rules, shard_module_

    mesh = make_mesh(MeshSpec(*spec))
    dit = DiT(DiTConfig(**cfg_kw))
    dit.load_state_dict(inp[sd_key])
    shard_module_(dit, dit_param_rules(), mesh)
    bs = _batch(mesh, inp["dit"]["x"].shape[0])
    x = {k: _t(v)[bs] for k, v in inp["dit"].items()}
    with torch.no_grad():
        out = dit(x["x"], x["t"], x["ctx"], ref_concat=x["ref"], concat_smpl_render=x["smpl"],
                  image_clip_features=x["clip"], mesh=mesh)
    return dict(coords=mesh.coords, out=out)


def _w_world4(inp):
    from scail_tpu_torch.parallel import MeshSpec, make_mesh
    from scail_tpu_torch.parallel.comm import COLLECTIVES, reset_collective_counts
    from scail_tpu_torch.parallel.cross_entropy import vocab_parallel_cross_entropy
    from scail_tpu_torch.parallel.ring import ring_attention
    from scail_tpu_torch.parallel.ulysses import ulysses_attention

    res = {}
    for name, spec in (("seq4", (1, 4, 1)), ("seq2", (2, 2, 1))):
        reset_collective_counts()
        res[f"ulysses_{name}"] = _attention_case(spec, ulysses_attention, inp["attn"])
        res[f"ulysses_{name}"]["collectives"] = dict(COLLECTIVES)
        reset_collective_counts()
        res[f"ring_{name}"] = _attention_case(spec, ring_attention, inp["attn"])
        res[f"ring_{name}"]["collectives"] = dict(COLLECTIVES)
    for name, kw, spec in (("dit_ulysses", dict(TINY, attn_impl="ulysses"), (1, 2, 2)),
                           ("dit_ring", dict(TINY, attn_impl="ring"), (1, 2, 2)),
                           ("sta_ulysses", dict(TINY, **STA), (1, 2, 2)),
                           ("sta_tp", dict(TINY, **STA), (2, 1, 2))):
        res[name] = _dit_case(inp, kw, spec, "sd4")
    res["dit_122"] = _dit_case(inp, dict(TINY2, attn_impl="xla"), (1, 2, 2), "sd2")

    mesh = make_mesh(MeshSpec(1, 1, 4))
    logits = _t(inp["ce"]["logits"])
    v_local = logits.shape[-1] // 4
    local = logits[..., mesh.rank("model") * v_local:(mesh.rank("model") + 1) * v_local]
    local = local.clone().requires_grad_(True)
    nll = vocab_parallel_cross_entropy(local, _t(inp["ce"]["targets"]), mesh)
    nll.sum().backward()
    res["ce"] = dict(coords=mesh.coords, nll=nll.detach(), grad=local.grad)
    return res


def _w_world8(inp):
    from scail_tpu_torch.parallel import MeshSpec, make_mesh
    from scail_tpu_torch.parallel.sharding import (dit_param_rules, gather_state_dict,
                                                   shard_state_dict)

    res = {name: _dit_case(inp, dict(TINY2, attn_impl="xla", **kw), (2, 2, 2), "sd2")
           for name, kw in (("dit", {}), ("dit_sa", dict(shard_activations=True)))}
    mesh = make_mesh(MeshSpec(2, 2, 2))
    full = inp["sd2"]
    local = shard_state_dict(full, dit_param_rules(), mesh)
    back = gather_state_dict(local, dit_param_rules(), mesh)
    res["gather"] = dict(coords=mesh.coords,
                         equal=all(torch.equal(back[n], full[n]) for n in full),
                         sharded=sorted(n for n in full if local[n].shape != full[n].shape))
    return res


# --------------------------------------------------------------------------
# Inputs, the JAX side and the fixtures
# --------------------------------------------------------------------------
def _dit_inputs(b=2, seed=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(b, 2, 16, 8, 8), t=np.array([100.0, 200.0], np.float32)[:b],
                ctx=f(b, 7, 16), ref=f(b, 1, 16, 8, 8), smpl=f(b, 2, 16, 4, 4),
                clip=f(b, 5, 8))


def _jax_params(kw):
    import jax

    from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
    from scail_tpu.models.dit import init_dit_params

    return init_dit_params(jax.random.PRNGKey(0), JaxDiTConfig(**kw))


def _jax_dit(params, kw, inp, mesh_spec=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
    from scail_tpu.models.dit import dit_forward, dit_param_rules
    from scail_tpu.parallel.mesh import DATA_AXIS, SEQ_AXIS, MeshSpec, make_mesh
    from scail_tpu.parallel.sharding import shard_tree

    cfg = JaxDiTConfig(**kw)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    if mesh_spec is None:
        return np.asarray(dit_forward(params, cfg, j["x"], j["t"], j["ctx"], ref_concat=j["ref"],
                                      concat_smpl_render=j["smpl"],
                                      image_clip_features=j["clip"]))
    spec = MeshSpec(*mesh_spec)
    mesh = make_mesh(spec, devices=jax.devices()[:spec.world])
    sp = shard_tree(params, dit_param_rules(), mesh)
    x = jax.device_put(j["x"], NamedSharding(mesh, P(DATA_AXIS, None, None, None, SEQ_AXIS)))
    run = jax.jit(lambda p, x: dit_forward(p, cfg, x, j["t"], j["ctx"], ref_concat=j["ref"],
                                           concat_smpl_render=j["smpl"],
                                           image_clip_features=j["clip"], mesh=mesh))
    return np.asarray(run(sp, x))


def _jax_attention(fn_name, inp, seq):
    """JAX ulysses_attention / ring_attention on a (1, seq, 1) mesh: the output
    and the gradients of sum(out * dO)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from scail_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, MeshSpec, make_mesh
    from scail_tpu.parallel.ring import ring_attention
    from scail_tpu.parallel.ulysses import ulysses_attention

    mesh = make_mesh(MeshSpec(1, seq, 1), devices=jax.devices()[:seq])
    if fn_name == "ulysses":
        fn = lambda q, k, v: ulysses_attention(q, k, v, mesh, impl="xla")  # noqa: E731
    else:
        fn = lambda q, k, v: ring_attention(q, k, v, mesh)  # noqa: E731
    sh = NamedSharding(mesh, P(DATA_AXIS, SEQ_AXIS, MODEL_AXIS, None))
    q, k, v, do = (jax.device_put(jnp.asarray(inp[n]), sh) for n in ("q", "k", "v", "do"))
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * do), argnums=(0, 1, 2)))(
        q, k, v)
    return dict(out=np.asarray(out), dq=np.asarray(grads[0]), dk=np.asarray(grads[1]),
                dv=np.asarray(grads[2]))


def _assemble(results, case, key, shape, row_dim=None):
    """The full array from every rank's piece: data slices of dim 0 and, with
    row_dim, seq rows of that dim (ranks that differ only in 'model' hold the
    same piece)."""
    out = np.full(shape, np.nan, np.float32)
    for r in results:
        rec = r[case]
        c = rec["coords"]
        idx = [slice(None)] * len(shape)
        n_data = max(x[case]["coords"]["data"] for x in results) + 1
        b = shape[0] // n_data
        idx[0] = slice(c["data"] * b, (c["data"] + 1) * b)
        if row_dim is not None:
            n_seq = max(x[case]["coords"]["seq"] for x in results) + 1
            s = shape[row_dim] // n_seq
            idx[row_dim] = slice(c["seq"] * s, (c["seq"] + 1) * s)
        out[tuple(idx)] = rec[key].numpy()
    assert not np.isnan(out).any()
    return out


@pytest.fixture(scope="module")
def worlds():
    """Start the world-4 and world-8 runs, compute the JAX side meanwhile."""
    from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax

    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    attn = dict(q=f(2, 64, 8, 16), k=f(2, 64, 8, 16), v=f(2, 64, 8, 16), do=f(2, 64, 8, 16))
    ce = dict(logits=f(2, 6, 32), targets=rng.integers(0, 32, (2, 6)).astype(np.int64))
    p4, p2 = _jax_params(TINY), _jax_params(TINY2)
    inputs = dict(attn=attn, ce=ce, dit=_dit_inputs(), sd4=dit_state_dict_from_jax(p4),
                  sd2=dit_state_dict_from_jax(p2))
    with tempfile.TemporaryDirectory() as d4, tempfile.TemporaryDirectory() as d8:
        for d in (d4, d8):
            torch.save(inputs, os.path.join(d, "inputs.pt"))
        procs4 = spawn_world("test_torch_parallel", "_w_world4", 4, d4)
        procs8 = spawn_world("test_torch_parallel", "_w_world8", 8, d8)
        try:
            jax_ref = dict(
                attn={(fn, seq): _jax_attention(fn, attn, seq)
                      for fn in ("ulysses", "ring") for seq in (2, 4)},
                dit=_jax_dit(p2, dict(TINY2, attn_impl="xla"), inputs["dit"], (2, 2, 2)),
                dit_sa=_jax_dit(p2, dict(TINY2, attn_impl="xla", shard_activations=True),
                                inputs["dit"], (2, 2, 2)),
                dit_122=_jax_dit(p2, dict(TINY2, attn_impl="xla"), inputs["dit"], (1, 2, 2)),
                dit_ulysses=_jax_dit(p4, dict(TINY, attn_impl="ulysses"), inputs["dit"],
                                     (1, 2, 2)),
                dit_ring=_jax_dit(p4, dict(TINY, attn_impl="ring"), inputs["dit"], (1, 2, 2)),
                dense=_jax_dit(p4, dict(TINY, attn_impl="xla"), inputs["dit"]))
        finally:
            res4 = collect_world(procs4, d4)
            res8 = collect_world(procs8, d8)
    return dict(w4=res4, w8=res8, jax=jax_ref, inputs=inputs, params2=p2)


# --------------------------------------------------------------------------
# Tests
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["ulysses", "ring"])
@pytest.mark.parametrize("seq", [2, 4])
def test_sequence_parallel_attention_matches_jax(worlds, fn, seq):
    """Ulysses and ring attention over 2 and 4 seq ranks (the 2-rank case
    on a data 2 x seq 2 mesh), output and gradients, against the JAX
    functions on a seq mesh of the same size."""
    case = f"{fn}_seq{seq}"
    want = worlds["jax"]["attn"][(fn, seq)]
    shape = worlds["inputs"]["attn"]["q"].shape
    for key in ("out", "dq", "dk", "dv"):
        got = _assemble(worlds["w4"], case, key, shape, row_dim=1)
        np.testing.assert_allclose(got, want[key], rtol=2e-4, atol=2e-4, err_msg=key)
    # Ulysses: q, k, v and o exchanged, and their inverses in the backward;
    # the ring: P - 1 hops forward, P backward (the dk/dv sums go home)
    counts = worlds["w4"][0][case]["collectives"]
    if fn == "ulysses":
        assert counts["all_to_all"] == 8 and counts["p2p"] == 0, counts
    else:
        assert counts["p2p"] == (seq - 1) + seq and counts["all_to_all"] == 0, counts


@pytest.mark.parametrize("case", ["dit", "dit_sa", "dit_122"])
def test_sharded_dit_matches_jax_sharded_forward(worlds, case):
    """The DiT at (data 2, seq 2, model 2) on 8 ranks, with and without
    shard_activations, and at (data 1, seq 2, model 2) on 4 ranks, against
    JAX's dit_forward on the same mesh."""
    want = worlds["jax"][case]
    got = _assemble(worlds["w4" if case == "dit_122" else "w8"], case, "out", want.shape)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("case", ["dit_ulysses", "dit_ring"])
def test_dit_sequence_parallel_impls_match_jax(worlds, case):
    """attn_impl 'ulysses' and 'ring' in the DiT at (1, 2, 2) on 4 ranks
    against JAX's dit_forward with the same impl on the same mesh."""
    want = worlds["jax"][case]
    got = _assemble(worlds["w4"], case, "out", want.shape)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("case", ["sta_tp", "sta_ulysses"])
def test_dit_sta_under_a_mesh_matches_jax(worlds, case):
    """Sliding-tile attention under TP 2 (data 2 x model 2: the windowed
    kernels on the rank's heads) and under seq 2 x model 2 (Ulysses with the
    windowed kernels inside), a window that covers every tile, against JAX's
    dense forward."""
    want = worlds["jax"]["dense"]
    got = _assemble(worlds["w4"], case, "out", want.shape)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_vocab_parallel_cross_entropy_matches_jax(worlds):
    """Vocab-parallel cross entropy over 4 model ranks, value and gradient,
    against JAX's on a model-4 mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from scail_tpu.parallel.cross_entropy import vocab_parallel_cross_entropy
    from scail_tpu.parallel.mesh import MODEL_AXIS, MeshSpec, make_mesh

    ce = worlds["inputs"]["ce"]
    mesh = make_mesh(MeshSpec(1, 1, 4), devices=jax.devices()[:4])
    logits = jax.device_put(jnp.asarray(ce["logits"]),
                            NamedSharding(mesh, P(None, None, MODEL_AXIS)))
    targets = jnp.asarray(ce["targets"], jnp.int32)
    want = np.asarray(jax.jit(lambda lg: vocab_parallel_cross_entropy(lg, targets, mesh))(logits))
    g_want = np.asarray(jax.jit(jax.grad(lambda lg: jnp.sum(
        vocab_parallel_cross_entropy(lg, targets, mesh))))(logits))
    recs = sorted((r["ce"] for r in worlds["w4"]), key=lambda r: r["coords"]["model"])
    for rec in recs:
        np.testing.assert_allclose(rec["nll"].numpy(), want, rtol=2e-5, atol=2e-5)
    g_got = np.concatenate([rec["grad"].numpy() for rec in recs], axis=-1)
    np.testing.assert_allclose(g_got, g_want, rtol=2e-5, atol=2e-5)


def test_sharded_state_dict_gathers_back_bit_exact(worlds):
    """shard_state_dict then gather_state_dict on the (2, 2, 2) world gives
    every tensor back bit-exact on every rank, and the rules shard the
    column- and row-parallel weights of every layer."""
    for r in worlds["w8"]:
        assert r["gather"]["equal"], r["gather"]["coords"]
    sharded = worlds["w8"][0]["gather"]["sharded"]
    per_layer = {"qkv.weight", "qkv.bias", "cross_q.weight", "cross_q.bias", "cross_kv.weight",
                 "cross_kv.bias", "clip_kv.weight", "clip_kv.bias", "mlp_in.weight",
                 "mlp_in.bias", "attn_out.weight", "cross_out.weight", "mlp_out.weight"}
    assert set(sharded) == {f"layers.{i}.{n}" for i in range(2) for n in per_layer}


def test_param_specs_match_jax_rules(worlds):
    """The port's spec of every state_dict name equals JAX's
    specs_for_tree(dit_param_rules()) spec of the same leaf (the layer axis
    dropped and a kernel's two dims swapped, as the weight bridge swaps
    them)."""
    import jax

    from scail_tpu.models.dit import dit_param_rules as jax_rules
    from scail_tpu.parallel.sharding import specs_for_tree
    from scail_tpu_torch.parallel.sharding import dit_param_rules, specs_for_state_dict

    params = worlds["params2"]
    jspecs = specs_for_tree(params, jax_rules())
    port = specs_for_state_dict(worlds["inputs"]["sd2"], dit_param_rules())

    def pad(spec, ndim):
        return tuple(spec) + (None,) * (ndim - len(spec))

    checked = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        spec = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))[0]
        want = dict((tuple(str(getattr(p, "key", p)) for p in pp), s) for pp, s in spec)
        js = pad(want[tuple(keys)], leaf.ndim)
        names = keys[:-1] + ["weight" if keys[-1] == "kernel" else keys[-1]]
        if keys[0] == "layers":
            js = js[1:]
            targets = [".".join(["layers", str(i)] + names[1:]) for i in range(leaf.shape[0])]
        else:
            targets = [".".join(names)]
        if keys[-1] == "kernel":
            js = js[:-2] + (js[-1], js[-2])
        for t in targets:
            assert pad(port[t], len(js)) == js, (t, port[t], js)
            checked += 1
    assert checked == len(port)


def test_h_w_shift_forward_matches_jax():
    """A DiT forward with nonzero h_shift / w_shift (the sequence-parallel
    RoPE shifts of the reference) against JAX's, one process."""
    import jax.numpy as jnp

    from scail_tpu.models.dit import DiTConfig as JaxDiTConfig
    from scail_tpu.models.dit import dit_forward
    from scail_tpu_torch.convert.from_jax import dit_state_dict_from_jax
    from scail_tpu_torch.models.dit import DiT, DiTConfig

    params = _jax_params(TINY)
    inp = _dit_inputs(b=1, seed=9)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    want = np.asarray(dit_forward(params, JaxDiTConfig(**TINY, attn_impl="xla"), j["x"], j["t"],
                                  j["ctx"], ref_concat=j["ref"], concat_smpl_render=j["smpl"],
                                  image_clip_features=j["clip"], h_shift=2, w_shift=3))
    dit = DiT(DiTConfig(**TINY))
    dit.load_state_dict(dit_state_dict_from_jax(params))
    x = {k: _t(v) for k, v in inp.items()}
    with torch.no_grad():
        got = dit(x["x"], x["t"], x["ctx"], ref_concat=x["ref"], concat_smpl_render=x["smpl"],
                  image_clip_features=x["clip"], h_shift=2, w_shift=3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the shifts move the rotary tables (every segment alike, so the relative
    # rotary leaves the attention scores as they were)
    shifted, plain = dit._rope(2, 4, 4, 2, 3, "cpu"), dit._rope(2, 4, 4, 0, 0, "cpu")
    assert not torch.equal(shifted.cos, plain.cos)
