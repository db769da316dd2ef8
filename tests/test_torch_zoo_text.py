"""The port's text encoders (BERT, RoBERTa, DPR, T5) against the JAX
package, on the CPU, f32.

Each model: its released-layout converter (`*_from_hf` on a tiny HF model
that `transformers` builds) equals the JAX converter through the weight
bridge, exactly; the forward on those weights equals the JAX forward within
1e-4 and HF's outputs within 2e-4 (the JAX tests' bound).  T5's bucket table
equals JAX's exactly past max_distance; its cached decode equals full
recompute (logits 1e-5) and JAX's cached decode; greedy tokens equal JAX's
exactly.
"""

import numpy as np
import pytest
import torch


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _sd(m):
    return {k: v.detach().float() for k, v in m.state_dict().items()}


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _same(port_sd, bridged):
    assert set(port_sd) == set(bridged), set(port_sd) ^ set(bridged)
    for k, v in bridged.items():
        assert torch.equal(port_sd[k].float(), v), k


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _drawn(hf, seed):
    """HF's state dict with every bias and LayerNorm weight drawn (HF inits
    them to 0 / 1, where a swapped name would pass unseen), loaded back."""
    g = torch.Generator().manual_seed(seed)
    sd = _sd(hf)
    with torch.no_grad():
        for k, v in sd.items():
            if k.endswith(".bias") or "LayerNorm.weight" in k or "layer_norm.weight" in k:
                v.add_(0.05 * torch.randn(v.shape, generator=g))
    hf.load_state_dict(sd, strict=False)
    return sd


def _jit(fwd, cfg):
    import jax

    return jax.jit(lambda params, *args: fwd(params, cfg, *args))


# --------------------------------------------------------------------------
# BERT / RoBERTa
# --------------------------------------------------------------------------
def _bert_case(name):
    import transformers as tf

    from scail_tpu.models.zoo import bert as J
    from scail_tpu_torch.models.zoo import bert as P

    if name == "bert":
        hf = tf.BertModel(tf.BertConfig(
            vocab_size=90, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=48, max_position_embeddings=24, type_vocab_size=2,
            hidden_act="gelu", layer_norm_eps=1e-12, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0))
        kw = dict(vocab_size=90, dim=32, num_heads=4, num_layers=2, inner_hidden_size=48,
                  max_len=24, type_vocab_size=2)
        return hf, J.BertConfig(**kw), J.bert_params_from_hf, P.BertConfig(**kw), P.bert_from_hf
    hf = tf.RobertaModel(tf.RobertaConfig(
        vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=48, max_position_embeddings=34, type_vocab_size=1, pad_token_id=1,
        hidden_act="gelu", layer_norm_eps=1e-5, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0))
    kw = dict(vocab_size=100, dim=32, num_heads=4, num_layers=2, inner_hidden_size=48,
              max_len=34, type_vocab_size=1, eps=1e-5, position_style="roberta", pad_token_id=1)
    return (hf, J.BertConfig(**kw), J.roberta_params_from_hf, P.BertConfig(**kw),
            P.roberta_from_hf)


@pytest.mark.parametrize("name", ["bert", "roberta"])
def test_bert_and_roberta_match_jax_and_hf(name):
    """Padded rows included: the pad keys masked at -1e30, RoBERTa's
    positions from the cumsum of non-pad ids; the token types drawn."""
    import jax.numpy as jnp

    from scail_tpu.models.zoo import bert as J
    from scail_tpu_torch.convert.from_jax import encoder_state_dict_from_jax
    from scail_tpu_torch.models.zoo.bert import Bert

    torch.manual_seed(4)
    hf, jcfg, jconv, pcfg, pconv = _bert_case(name)
    hf = hf.eval()
    sd = _drawn(hf, 4)
    jparams = jconv(_np(sd), jcfg)
    port_sd = pconv(sd, pcfg)
    _same(port_sd, encoder_state_dict_from_jax(jparams))
    model = Bert(pcfg, device="cpu")
    model.load_state_dict(port_sd)

    rng = np.random.default_rng(4)
    ids = rng.integers(2, pcfg.vocab_size, (2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[1, 6:] = 0
    ids[1, 6:] = 1  # RoBERTa's pad id
    tt = rng.integers(0, pcfg.type_vocab_size, (2, 10))
    with torch.no_grad():
        seq, pooled = model(_t(ids), _t(mask), _t(tt))
        out = hf(input_ids=_t(ids), attention_mask=_t(mask), token_type_ids=_t(tt))
    jseq, jpooled = _jit(J.bert_forward, jcfg)(jparams, *(jnp.asarray(a, jnp.int32)
                                                          for a in (ids, mask, tt)))
    _close(seq, jseq)
    _close(pooled, jpooled)
    m = mask[:, :, None]  # HF's padded rows differ where masked out
    _close(seq.numpy() * m, out.last_hidden_state.numpy() * m, 2e-4)
    _close(pooled, out.pooler_output, 2e-4)


# --------------------------------------------------------------------------
# DPR
# --------------------------------------------------------------------------
def _dpr_hf_config(projection_dim):
    import transformers as tf

    return tf.DPRConfig(vocab_size=90, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=48,
                        max_position_embeddings=32, type_vocab_size=2,
                        projection_dim=projection_dim, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)


@pytest.mark.parametrize("tower", ["question_encoder", "ctx_encoder", "reader"])
def test_dpr_matches_jax_and_hf(tower):
    """The two encoders (projection 12) and the reader (projection 0): the
    HF prefixes stripped, the absent pooler zero in both packages."""
    import jax.numpy as jnp
    import transformers as tf

    from scail_tpu.models.zoo import dpr as J
    from scail_tpu.models.zoo.bert import BertConfig as JB
    from scail_tpu_torch.convert.from_jax import encoder_state_dict_from_jax
    from scail_tpu_torch.models.zoo import dpr as P
    from scail_tpu_torch.models.zoo.bert import BertConfig as PB

    torch.manual_seed(9)
    bkw = dict(vocab_size=90, dim=32, num_heads=4, num_layers=2, inner_hidden_size=48,
               max_len=32, type_vocab_size=2)
    proj = 0 if tower == "reader" else 12
    jcfg, pcfg = J.DPRConfig(JB(**bkw), proj), P.DPRConfig(PB(**bkw), proj)
    cls = {"question_encoder": tf.DPRQuestionEncoder, "ctx_encoder": tf.DPRContextEncoder,
           "reader": tf.DPRReader}[tower]
    hf = cls(_dpr_hf_config(proj)).eval()
    sd = _drawn(hf, 9)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 90, (2, 8))
    mask = np.ones((2, 8), np.int64)
    mask[1, 5:] = 0
    jargs = [jnp.asarray(a, jnp.int32) for a in (ids, mask)]
    with torch.no_grad():
        out = hf(_t(ids), attention_mask=_t(mask))
    if tower == "reader":
        jparams = J.dpr_reader_params_from_hf(_np(sd), jcfg)
        port_sd = P.dpr_reader_from_hf(sd, pcfg)
        model = P.DPRReader(pcfg, device="cpu")
        want = _jit(J.dpr_read, jcfg)(jparams, *jargs)
        want_hf = (out.start_logits, out.end_logits, out.relevance_logits)
    else:
        jparams = J.dpr_encoder_params_from_hf(_np(sd), jcfg, tower=tower)
        port_sd = P.dpr_encoder_from_hf(sd, pcfg, tower=tower)
        model = P.DPREncoder(pcfg, device="cpu")
        want = (_jit(J.dpr_encode, jcfg)(jparams, *jargs),)
        want_hf = (out.pooler_output,)
    _same(port_sd, encoder_state_dict_from_jax(jparams))
    model.load_state_dict(port_sd)
    with torch.no_grad():
        got = model(_t(ids), _t(mask))
    got = got if isinstance(got, tuple) else (got,)
    for g, w, h in zip(got, want, want_hf):
        _close(g, w)
        _close(g, h, 2e-4)


# --------------------------------------------------------------------------
# T5
# --------------------------------------------------------------------------
T5_KW = dict(vocab_size=80, dim=32, dim_kv=8, num_heads=4, inner_hidden_size=48, num_layers=2,
             num_decoder_layers=2, num_buckets=8, max_distance=16)


@pytest.mark.parametrize("lq,lk,bidirectional", [(40, 40, True), (40, 40, False),
                                                 (3, 57, True), (57, 3, False)])
def test_t5_buckets_equal_jax_past_max_distance(lq, lk, bidirectional):
    """The host table, exactly, where distances pass max_distance (16) and
    the log buckets saturate."""
    from scail_tpu.models.zoo.t5 import _rel_buckets
    from scail_tpu_torch.models.zoo.t5 import rel_buckets

    want = np.asarray(_rel_buckets(lq, lk, 8, 16, bidirectional))
    got = rel_buckets(lq, lk, 8, 16, bidirectional)
    assert (np.abs(np.arange(lk)[None] - np.arange(lq)[:, None]) > 16).any()
    assert got.shape == (lq, lk) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def _t5_hf(seed, **extra):
    import transformers as tf

    torch.manual_seed(seed)
    return tf.T5ForConditionalGeneration(tf.T5Config(
        vocab_size=80, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_decoder_layers=2,
        num_heads=4, relative_attention_num_buckets=8, relative_attention_max_distance=32,
        dropout_rate=0.0, feed_forward_proj="gated-gelu", tie_word_embeddings=False,
        decoder_start_token_id=0, **extra)).eval()


def test_t5_matches_jax_and_hf():
    """t5_forward on HF's weights (a padded encoder row), and the greedy
    tokens against JAX's and HF's generate."""
    import jax.numpy as jnp

    from scail_tpu.models.zoo import t5 as J
    from scail_tpu_torch.convert.from_jax import encoder_state_dict_from_jax
    from scail_tpu_torch.models.zoo import t5 as P

    hf = _t5_hf(1, eos_token_id=1, pad_token_id=0)
    sd = _drawn(hf, 1)
    kw = dict(T5_KW, max_distance=32)
    jcfg, pcfg = J.T5Config(**kw), P.T5Config(**kw)
    jparams = J.t5_params_from_hf(_np(sd), jcfg)
    port_sd = P.t5_from_hf(sd, pcfg)
    _same(port_sd, encoder_state_dict_from_jax(jparams))
    model = P.T5(pcfg, device="cpu")
    model.load_state_dict(port_sd)

    rng = np.random.default_rng(1)
    ids = rng.integers(2, 80, (2, 11))
    mask = np.ones((2, 11), np.int64)
    mask[1, 7:] = 0
    dec = rng.integers(0, 80, (2, 5))
    with torch.no_grad():
        got = model(_t(ids), _t(mask), _t(dec))
        want_hf = hf(input_ids=_t(ids), attention_mask=_t(mask), decoder_input_ids=_t(dec)).logits
        greedy = P.t5_greedy_decode(model, _t(ids), _t(mask), 6, start_token_id=0,
                                    eos_token_id=1)
        hf_greedy = hf.generate(input_ids=_t(ids), attention_mask=_t(mask), max_new_tokens=6,
                                do_sample=False, num_beams=1)
    jids, jmask = jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)
    _close(got, _jit(J.t5_forward, jcfg)(jparams, jids, jmask, jnp.asarray(dec, jnp.int32)))
    _close(got, want_hf, 2e-4)
    jgreedy = np.asarray(J.t5_greedy_decode(jparams, jcfg, jids, jmask, 6, start_token_id=0,
                                            eos_token_id=1))
    np.testing.assert_array_equal(greedy.numpy(), jgreedy)
    n = min(greedy.shape[1], hf_greedy.shape[1] - 1)
    np.testing.assert_array_equal(greedy.numpy()[:, :n], hf_greedy.numpy()[:, 1:1 + n])


@pytest.mark.parametrize("gated,tied", [(True, False), (False, True)])
def test_t5_cached_decode_matches_full_recompute_and_jax(gated, tied):
    """JAX's init through the bridge (gated GELU and untied, ReLU and tied):
    a 3-row prefill then three one-row steps through the cache equal the
    full decoder (1e-5) and JAX's cached decode (1e-4); greedy tokens from
    eos-free decoding equal JAX's."""
    import jax
    import jax.numpy as jnp

    from scail_tpu.models.zoo import t5 as J
    from scail_tpu_torch.convert.from_jax import encoder_state_dict_from_jax
    from scail_tpu_torch.models.zoo import t5 as P

    kw = dict(T5_KW, gated_mlp=gated, tie_word_embeddings=tied)
    jcfg = J.T5Config(**kw)
    params = jax.jit(lambda k: J.init_t5_params(k, jcfg))(jax.random.PRNGKey(1))
    model = P.T5(P.T5Config(**kw), device="cpu")
    model.load_state_dict(encoder_state_dict_from_jax(params))
    rng = np.random.default_rng(2)
    ids, dec = rng.integers(0, 80, (2, 7)), rng.integers(0, 80, (2, 6))
    mask = np.ones((2, 7), np.int64)
    mask[0, 5:] = 0
    with torch.no_grad():
        enc = model.encode(_t(ids), _t(mask))
        full = model.decode(_t(dec), enc, _t(mask))
        cache = model.init_cache(enc, 8)
        chunks = [model.decode_cached(_t(dec[:, :3]), cache, _t(mask))]
        chunks += [model.decode_cached(_t(dec[:, i:i + 1]), cache, _t(mask))
                   for i in range(3, 6)]
        greedy = P.t5_greedy_decode(model, _t(ids), _t(mask), 5)
    inc = torch.cat(chunks, dim=1)
    assert cache.length == 6
    _close(inc, full, 1e-5)

    jids, jmask = jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)
    jenc = _jit(J.t5_encode, jcfg)(params, jids, jmask)
    _close(enc, jenc)
    _close(full, _jit(J.t5_decode, jcfg)(params, jnp.asarray(dec, jnp.int32), jenc, jmask))
    step = jax.jit(lambda p, d, c, m: J.t5_decode_cached(p, jcfg, d, c, m))
    jcache = J.init_t5_cache(params, jcfg, jenc, 8)
    jchunks = []
    for lo, hi in ((0, 3), (3, 4), (4, 5), (5, 6)):
        out, jcache = step(params, jnp.asarray(dec[:, lo:hi], jnp.int32), jcache, jmask)
        jchunks.append(np.asarray(out))
    _close(inc, np.concatenate(jchunks, axis=1))
    np.testing.assert_array_equal(
        greedy.numpy(), np.asarray(J.t5_greedy_decode(params, jcfg, jids, jmask, 5)))
