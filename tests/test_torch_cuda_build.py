"""The kernel build's cache key covers every file the kernels are compiled from.

`scail_tpu_torch.ops.cuda_build` names the library after a hash of
`SOURCES`, `HEADERS` and the flags, so an edited source never reaches a run
through a stale `.so`.  These CPU tests hold the two lists to what the
sources actually include.
"""

import re
import shutil

from scail_tpu_torch.ops import cuda_build

INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def test_every_quoted_include_is_hashed():
    hashed = set(cuda_build.SOURCES) | set(cuda_build.HEADERS)
    for path in sorted(cuda_build.CSRC_DIR.glob("*.cu*")):
        for name in INCLUDE.findall(path.read_text()):
            assert name in hashed, f"{path.name} includes {name}, which the build hash misses"


def test_every_csrc_file_is_built_or_hashed():
    on_disk = {p.name for p in cuda_build.CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh")}
    assert on_disk == set(cuda_build.SOURCES) | set(cuda_build.HEADERS)
    assert all(name.endswith(".cu") for name in cuda_build.SOURCES)
    assert all(name.endswith(".cuh") for name in cuda_build.HEADERS)


def test_editing_any_header_changes_the_library_name(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    base = cuda_build._digest()
    for name in cuda_build.HEADERS:
        path = csrc / name
        text = path.read_text()
        path.write_text(text + "\n// edited\n")
        assert cuda_build._digest() != base, name
        path.write_text(text)
    assert cuda_build._digest() == base


def test_every_header_is_included_by_some_source():
    """No dead header lingers in HEADERS: each is included by a source or by
    a header that a source includes."""
    included, todo = set(), list(cuda_build.SOURCES)
    while todo:
        for name in INCLUDE.findall((cuda_build.CSRC_DIR / todo.pop()).read_text()):
            if name not in included:
                included.add(name)
                todo.append(name)
    assert set(cuda_build.HEADERS) <= included, set(cuda_build.HEADERS) - included
