"""The port's conditioning options against the JAX package's, on the CPU in
f32, with toy umt5 encoders (JAX-initialised weights bridged across) and one
tokenizer shared by both sides:

* the conditioner's correlated ucg (`cor_embs` / `cor_p`): the same joint
  RandomState draws (the generator states agree after every call) and the
  same outputs, string swap and zeroing, at 1e-4;
* umt5 `varlen_text`: the states trimmed to the valid tokens, padded to
  `cond_length_multiple`, and `uncond_text_length` tokens for a prompt of one
  token or none, on the same ids and mask, at 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from scail_tpu.diffusion.conditioner import GeneralConditioner as JaxConditioner
from scail_tpu.models import umt5 as jt5
from scail_tpu_torch.convert.from_jax import umt5_state_dict_from_jax
from scail_tpu_torch.diffusion.conditioner import GeneralConditioner
from scail_tpu_torch.models import umt5 as tt5

TOL = dict(rtol=1e-4, atol=1e-4)
UMT5 = dict(vocab_size=100, dim=16, dim_attn=16, dim_ffn=24, num_heads=2, num_layers=1,
            num_buckets=8, dtype="float32")
T5 = "sgm.modules.encoders.umt5.T5EncoderModel"


def _pair_encoders(jemb, temb, seed):
    """Toy weights from one JAX init in both wrappers, and one tokenizer."""
    jemb.init(jax.random.PRNGKey(seed), jt5.UMT5Config(**UMT5))
    temb.init(torch.Generator().manual_seed(0), tt5.UMT5Config(**UMT5))
    temb.model.load_state_dict(umt5_state_dict_from_jax(jemb.params))
    jemb.tokenizer = temb.tokenizer = tt5.StableHashTokenizer(jemb.max_length, 100)


def _conditioners(cor_embs, cor_p):
    emb_models = [
        {"target": T5, "input_key": "txt", "ucg_rate": 0.4, "legacy_ucg_val": "",
         "params": {"max_length": 8, "dtype": "float32"}},
        {"target": T5, "input_key": "txt2", "ucg_rate": 0.5,
         "params": {"max_length": 8, "dtype": "float32"}},
        {"target": T5, "input_key": "txt", "ucg_rate": 0.3,
         "params": {"max_length": 8, "dtype": "float32"}},
    ]
    pair = (JaxConditioner(emb_models, cor_embs=cor_embs, cor_p=cor_p),
            GeneralConditioner(emb_models, cor_embs=cor_embs, cor_p=cor_p))
    for i, (jemb, temb) in enumerate(zip(*(c.embedders for c in pair))):
        _pair_encoders(jemb, temb, seed=i)
    return pair


@pytest.mark.parametrize("cor_embs, cor_p", [
    ([0, 1], [0.1, 0.3, 0.2, 0.4]),  # both drawn jointly: bit 0 drops txt, bit 1 txt2
    ([1], [0.35, 0.65]),             # txt2 correlated alone, the others independent
])
def test_correlated_ucg_matches_jax(cor_embs, cor_p):
    jcond, tcond = _conditioners(cor_embs, cor_p)
    batch = {"txt": ["a character dancing", "two people walk", "someone jumps high",
                     "a dog", "slow turn left"],
             "txt2": ["red", "blue green", "yellow", "", "white black"]}
    order = cor_embs + [i for i in range(3) if i not in cor_embs]  # the correlated ones first
    txt2 = slice(16 * order.index(1), 16 * order.index(1) + 16)
    dropped = []
    for _ in range(4):
        want = np.asarray(jcond(dict(batch))["crossattn"])
        with torch.no_grad():
            got = tcond(dict(batch))["crossattn"].numpy()
        assert got.shape == want.shape == (5, 8, 48)  # three encoders' features concatenated
        np.testing.assert_allclose(got, want, **TOL)
        dropped.append(~got[:, :, txt2].any(axis=(1, 2)))  # txt2 zeroed per element
        for a, b in zip(jcond.ucg_prng.get_state()[1:], tcond.ucg_prng.get_state()[1:]):
            np.testing.assert_array_equal(a, b)
    dropped = np.stack(dropped)
    assert dropped.any() and not dropped.all()  # the draws drop some elements, not all
    # ucg disabled: no draw, every embedder on
    state = tcond.ucg_prng.get_state()[1].copy()
    c, uc = tcond.get_unconditional_conditioning(dict(batch), force_uc_zero_embeddings=["txt2"])
    jc, juc = jcond.get_unconditional_conditioning(dict(batch),
                                                   force_uc_zero_embeddings=["txt2"])
    np.testing.assert_array_equal(tcond.ucg_prng.get_state()[1], state)
    np.testing.assert_allclose(c["crossattn"].numpy(), np.asarray(jc["crossattn"]), **TOL)
    np.testing.assert_allclose(uc["crossattn"].numpy(), np.asarray(juc["crossattn"]), **TOL)


def test_cor_p_needs_one_probability_per_combination():
    with pytest.raises(ValueError, match="cor_p"):
        GeneralConditioner([], cor_embs=[0, 1], cor_p=[0.5, 0.5])


class _FixedTokens:
    """A tokenizer that hands out given ids and mask."""

    def __init__(self, ids, mask):
        self.ids, self.mask = ids, mask

    def __call__(self, texts, return_mask=True):
        return self.ids, self.mask


@pytest.mark.parametrize("valid, multiple, uncond", [
    (0, 1, 1), (1, 1, 1), (5, 1, 1), (12, 1, 1), (5, 4, 1), (1, 4, 3), (0, 1, 2),
])
def test_varlen_text_matches_jax(valid, multiple, uncond):
    jemb = jt5.T5EncoderModel(max_length=12, dtype="float32", varlen_text=True,
                              uncond_text_length=uncond)
    temb = tt5.T5EncoderModel(max_length=12, dtype="float32", varlen_text=True,
                              uncond_text_length=uncond)
    _pair_encoders(jemb, temb, seed=3)
    jemb.cond_length_multiple = temb.cond_length_multiple = multiple
    rng = np.random.default_rng(valid)
    ids = np.zeros((1, 12), np.int32)
    ids[0, :valid] = rng.integers(2, 100, valid)
    mask = (np.arange(12) < valid).astype(np.int32)[None]
    jemb.tokenizer = temb.tokenizer = _FixedTokens(ids, mask)
    want = np.asarray(jemb(["a prompt"]))
    with torch.no_grad():
        got = temb(["a prompt"]).numpy()
    length = tt5.varlen_length(valid, multiple, uncond)
    assert got.shape == want.shape == (1, length, 16)
    assert length == (uncond if valid <= 1 else -(-valid // multiple) * multiple)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="one prompt"):
        temb.tokenizer = _FixedTokens(np.repeat(ids, 2, 0), np.repeat(mask, 2, 0))
        temb(["a", "b"])
