"""Kernel-vs-plain checks that need an NVIDIA GPU (marker `cuda`).

Run on a machine with the card (tests/conftest.py imports jax, which the port's
machine need not have):  python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
Without a card each test skips (decided inside the fixture, never at import).
Limits: those of scail_tpu_torch.ops.attention.error_vs_plain, scaled to the
plain output (bf16 rounding of q, of P before P V and of the output).
"""

import pytest
import torch

from scail_tpu_torch.ops import attention as A


def _assert_close(got, want, lse=False):
    err = A.error_vs_plain(got, want, lse=lse)
    assert err["ok"], err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [None, True, False])
def test_flash_attention_kernel_matches_plain(cuda, rope):
    q, k, v = _rnd(cuda, 2, 150, 2, 128), _rnd(cuda, 2, 176, 2, 128), _rnd(cuda, 2, 176, 2, 128)
    tabs = None
    if rope is not None:
        ang = torch.randn(150, 64, generator=cuda, device="cuda")
        ang = ang.repeat_interleave(2, -1) if rope else torch.cat([ang, ang], -1)
        tabs = (ang.cos(), ang.sin())
    before = dict(A.LAUNCHES)
    out, lse = A.flash_attention(q, k, v, rope=tabs, rope_interleaved=bool(rope))
    torch.cuda.synchronize()
    name = "flash_attention" if rope is None else "flash_attention_rope"
    assert A.LAUNCHES[name] == before[name] + 1
    want, want_lse = A.flash_attention_plain(q.float(), k.float(), v.float(), rope=tabs,
                                             rope_interleaved=bool(rope))
    _assert_close(out, want)
    _assert_close(lse, want_lse, lse=True)


@pytest.mark.cuda
def test_dual_cross_attention_kernel_matches_plain(cuda):
    q = _rnd(cuda, 2, 200, 2, 128)
    kv = [_rnd(cuda, 2, s, 2, 128) for s in (37, 37, 21, 21)]
    out = A.dual_cross_attention_fused(q, *kv)
    torch.cuda.synchronize()
    want = A.dual_cross_attention_plain(q.float(), *(t.float() for t in kv))
    _assert_close(out, want)


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = _rnd(cuda, 1, 64, 2, 64)  # head dim 64
    with pytest.raises(ValueError):
        A.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        A.flash_attention(q.float(), q.float(), q.float())
