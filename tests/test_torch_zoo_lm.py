"""The port's decoder LM zoo, 2D local attention, generation and prefix
tuning against the JAX package, on the CPU, f32.

Each model: its released-layout converter (`*_from_hf` on a tiny HF model
that `transformers` builds, or `*_from_sat` on a SAT-layout state dict this
file writes) equals the JAX converter through the weight bridge, exactly;
the forward on those weights equals the JAX forward within 1e-4; the HF
ones also HF's logits (2e-4, the JAX tests' bound).  Cached decode equals
full recompute (logits 1e-5, greedy tokens exactly).  `filling_sequence`'s
greedy tokens and `BeamSearchStrategy`'s result equal JAX's exactly; the
top-k / top-p masks are held against the support JAX's sampler draws from,
and the draws' frequencies against the masked distribution (the draws
themselves cannot match `jax.random`).
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


def _jit(fwd, cfg, **kw):
    """fwd(params, cfg, *args, **kw) jitted over (params, *args); its logits
    (a forward that returns (logits, cache) gives the logits)."""
    import jax

    def run(params, *args):
        out = fwd(params, cfg, *args, **kw)
        return out[0] if isinstance(out, tuple) else out

    return jax.jit(run)


def _bridge(name):
    """convert/from_jax.py's bridge for the zoo module `name`."""
    from scail_tpu_torch.convert import from_jax

    module = {"chatglm3": "chatglm2", "glm130b_1d": "glm130b"}.get(name, name)
    return getattr(from_jax, f"{module}_state_dict_from_jax")


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# 2D local attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("q_shape,k_shape,kH,kW,causal", [
    ((2, 3, 6, 6), (2, 3, 6, 6), 5, 3, True),
    ((2, 3, 6, 6), (2, 3, 6, 6), 3, 3, False),
    ((2, 3, 8, 8), (2, 3, 4, 4), 3, 3, False),   # cross resolution
    ((1, 4, 8, 8), (1, 4, 8, 8), 17, 9, True),   # cuda2d's (2k - 1, k) at k = 9
])
def test_f_similar_and_f_weighting_match_jax(q_shape, k_shape, kH, kW, causal):
    import jax
    import jax.numpy as jnp

    from scail_tpu.ops import local_attn_2d as J
    from scail_tpu_torch.ops.local_attn_2d import causal_field, f_similar, f_weighting

    rng = np.random.default_rng(0)
    q = rng.standard_normal(q_shape).astype(np.float32)
    k = rng.standard_normal(k_shape).astype(np.float32)
    field = causal_field(kH, kW) if causal else kH * kW
    w = rng.standard_normal((q_shape[0], q_shape[2], q_shape[3], field)).astype(np.float32)
    similar = jax.jit(J.f_similar, static_argnums=(2, 3, 4))
    weighting = jax.jit(J.f_weighting, static_argnums=(2, 3, 4))
    _close(f_similar(_t(q), _t(k), kH, kW, causal),
           similar(jnp.asarray(q), jnp.asarray(k), kH, kW, causal))
    _close(f_weighting(_t(k), _t(w), kH, kW, causal),
           weighting(jnp.asarray(k), jnp.asarray(w), kH, kW, causal))


def test_local_attention_adjoint_and_gradients():
    """<f_similar(q, k), w> = <q, f_weighting(k, w)>; autograd reaches q
    and k."""
    from scail_tpu_torch.ops.local_attn_2d import causal_field, f_similar, f_weighting

    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((1, 2, 4, 4)).astype(np.float32)).requires_grad_(True)
    k = _t(rng.standard_normal((1, 2, 4, 4)).astype(np.float32)).requires_grad_(True)
    w = _t(rng.standard_normal((1, 4, 4, causal_field(5, 3))).astype(np.float32))
    lhs = (f_similar(q, k, 5, 3, True) * w).sum()
    rhs = (q * f_weighting(k, w, 5, 3, True)).sum()
    np.testing.assert_allclose(float(lhs.detach()), float(rhs.detach()), rtol=1e-4)
    f_similar(q, k, 3, 3, True).square().sum().backward()
    assert torch.isfinite(q.grad).all() and k.grad.abs().sum() > 0


# --------------------------------------------------------------------------
# HF-layout models
# --------------------------------------------------------------------------
def _hf_case(name):
    import transformers as tf

    if name == "llama":
        from scail_tpu.models.zoo import llama as J
        from scail_tpu_torch.models.zoo import llama as P

        hf = tf.LlamaForCausalLM(tf.LlamaConfig(
            vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32,
            rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=False,
            attention_dropout=0.0))
        kw = dict(vocab_size=96, dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
                  inner_hidden_size=48, max_len=32)
        return (hf, J.LlamaConfig(**kw), J.llama_params_from_hf, J.llama_forward,
                P.LlamaConfig(**kw), P.llama_from_hf, P.Llama, 9)
    if name == "gptneo":
        from scail_tpu.models.zoo import gptneo as J
        from scail_tpu_torch.models.zoo import gptneo as P

        hf = tf.GPTNeoForCausalLM(tf.GPTNeoConfig(
            vocab_size=96, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=48,
            max_position_embeddings=32, attention_types=[[["global", "local"], 1]],
            window_size=4, activation_function="gelu_new", attention_dropout=0.0,
            resid_dropout=0.0, embed_dropout=0.0))
        kw = dict(vocab_size=96, dim=32, num_layers=2, num_heads=4, inner_hidden_size=48,
                  max_len=32, window_size=4)
        return (hf, J.GPTNeoConfig(**kw), J.gptneo_params_from_hf, J.gptneo_forward,
                P.GPTNeoConfig(**kw), P.gptneo_from_hf, P.GPTNeo, 12)
    from scail_tpu.models.zoo import glm as J
    from scail_tpu_torch.models.zoo import glm as P

    hf = tf.GlmForCausalLM(tf.GlmConfig(
        vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, max_position_embeddings=32,
        partial_rotary_factor=0.5, rms_norm_eps=1e-5, attention_bias=True,
        tie_word_embeddings=False, attention_dropout=0.0, pad_token_id=0))
    kw = dict(vocab_size=96, dim=32, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
              inner_hidden_size=48, max_len=32, eps=1e-5)
    return (hf, J.GlmConfig(**kw), J.glm_params_from_hf, J.glm_forward, P.GlmConfig(**kw),
            P.glm_from_hf, P.Glm, 9)


@pytest.mark.parametrize("name", ["llama", "gptneo", "glm"])
def test_hf_models_match_jax_and_hf(name):
    import jax.numpy as jnp

    torch.manual_seed(8)
    hf, jcfg, jconv, jfwd, pcfg, pconv, pcls, s = _hf_case(name)
    hf = hf.eval()
    sd = _sd(hf)
    with torch.no_grad():
        for k, v in sd.items():  # HF zero-inits biases: draw them so they count
            if k.endswith(".bias"):
                v.normal_(0.0, 0.02)
        hf.load_state_dict(sd, strict=False)
    jparams = jconv(_np(sd), jcfg)
    port_sd = pconv(sd, pcfg)
    _same(port_sd, _bridge(name)(jparams))
    model = pcls(pcfg)
    model.load_state_dict(port_sd)
    ids = np.random.default_rng(8).integers(0, 96, (2, s))
    with torch.no_grad():
        got = model(_t(ids))
        got = got[0] if isinstance(got, tuple) else got
        want_hf = hf(_t(ids)).logits
    want = _jit(jfwd, jcfg)(jparams, jnp.asarray(ids, jnp.int32))
    _close(got, want)
    _close(got, want_hf, 2e-4)


# --------------------------------------------------------------------------
# SAT-layout models
# --------------------------------------------------------------------------
def _sat_block(rng, L, d, inner, fc1_out, fmt="transformer.layers.{}."):
    g = lambda *s: (0.05 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    sd = {}
    for i in range(L):
        p = fmt.format(i)
        for ln in ("input_layernorm", "post_attention_layernorm"):
            sd[p + ln + ".weight"] = 1.0 + g(d)
            sd[p + ln + ".bias"] = g(d)
        for name, (o, i_) in {"attention.query_key_value": (3 * d, d),
                              "attention.dense": (d, d), "mlp.dense_h_to_4h": (fc1_out, d),
                              "mlp.dense_4h_to_h": (d, inner)}.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = g(o, i_), g(o)
    sd["transformer.final_layernorm.weight"] = 1.0 + g(d)
    sd["transformer.final_layernorm.bias"] = g(d)
    return sd


def _positions_2d(b, s):
    pos = np.tile(np.arange(s), (b, 1))
    block = np.zeros((b, s), np.int64)
    block[:, s // 2:] = np.arange(1, s - s // 2 + 1)
    return np.stack([pos, block], axis=1)


def _sat_case(name, rng):
    """(sd, jax converter, jax cfg, jax forward args, port converter, port
    cfg, port class, the forward's extra args)."""
    V, d, L, b, s = 80, 32, 2, 2, 10
    g = lambda *sh: (0.05 * rng.standard_normal(sh)).astype(np.float32)  # noqa: E731
    ids = rng.integers(0, V, (b, s))
    mask = np.tril(np.ones((b, s, s), np.float32))
    mask[1, :, :3] = 1.0  # a bidirectional prefix on row 1
    if name == "chatglm":
        from scail_tpu.models.zoo import chatglm as J
        from scail_tpu_torch.models.zoo import chatglm as P

        kw = dict(vocab_size=V, dim=d, num_heads=4, num_layers=L, inner_hidden_size=64)
        sd = _sat_block(rng, L, d, 64, 64)
        sd["transformer.word_embeddings.weight"] = g(V, d)
        sd["mixins.chatglm-final.lm_head.weight"] = g(V, d)
        args = (ids, _positions_2d(b, s), mask)
        return (sd, J.chatglm_params_from_sat, J.ChatGLMConfig(**kw), J.chatglm_forward,
                P.chatglm_from_sat, P.ChatGLMConfig(**kw), P.ChatGLM, args)
    if name in ("chatglm2", "chatglm3"):
        from scail_tpu.models.zoo import chatglm23 as J
        from scail_tpu_torch.models.zoo import chatglm23 as P

        kw = dict(vocab_size=V, dim=d, num_heads=4, num_kv_heads=2, num_layers=L,
                  inner_hidden_size=48, max_len=16)
        make_j, make_p = ((J.ChatGLM2Config, P.ChatGLM2Config) if name == "chatglm2"
                          else (J.chatglm3_config, P.chatglm3_config))
        if name == "chatglm3":
            kw["base_scale"] = 2.0
        sd = {}
        qkv_out = (4 + 2 * 2) * 8
        for i in range(L):
            p = f"transformer.layers.{i}."
            sd[p + "input_layernorm.weight"] = 1.0 + g(d)
            sd[p + "post_attention_layernorm.weight"] = 1.0 + g(d)
            sd[p + "attention.query_key_value.weight"] = g(qkv_out, d)
            sd[p + "attention.query_key_value.bias"] = g(qkv_out)
            sd[p + "attention.dense.weight"] = g(d, d)
            sd[p + "mlp.dense_h_to_4h.weight"] = g(48, d)
            sd[p + "mlp.dense_4h_to_h.weight"] = g(d, 48)
            sd[f"mixins.mlp.w2.{i}.weight"] = g(48, d)
        sd["transformer.word_embeddings.weight"] = g(V, d)
        sd["transformer.final_layernorm.weight"] = 1.0 + g(d)
        sd["mixins.chatglm-final.lm_head.weight"] = g(V, d)
        pad = np.ones((b, s, s), np.float32)
        pad[0, :, :2] = 0.0  # two padded keys on row 0
        return (sd, J.chatglm2_params_from_sat, make_j(**kw),
                lambda p, c, t, pos, m: J.chatglm2_forward(p, c, t, pos, m)[0],
                P.chatglm2_from_sat, make_p(**kw), P.ChatGLM2,
                (ids, np.tile(np.arange(s), (b, 1)), pad))
    if name.startswith("glm130b"):
        from scail_tpu.models.zoo import glm130b as J
        from scail_tpu_torch.models.zoo import glm130b as P

        two_d = name == "glm130b"
        kw = dict(vocab_size=V, dim=d, num_heads=4, num_layers=L, inner_hidden_size=40,
                  position_encoding_2d=two_d, glu=two_d)
        sd = _sat_block(rng, L, d, 40, 80 if two_d else 40)
        sd["transformer.word_embeddings.weight"] = g(V, d)
        pos = _positions_2d(b, s) if two_d else np.tile(np.arange(s), (b, 1))
        return (sd, J.glm130b_params_from_sat, J.GLM130BConfig(**kw), J.glm130b_forward,
                P.glm130b_from_sat, P.GLM130BConfig(**kw), P.GLM130B, (ids, pos, mask))
    if name == "glmblock":
        from scail_tpu.models.zoo import glmblock as J
        from scail_tpu_torch.models.zoo import glmblock as P

        kw = dict(vocab_size=V, dim=d, num_heads=4, num_layers=L, inner_hidden_size=64,
                  max_len=s + 1)
        sd = _sat_block(rng, L, d, 64, 64)
        sd["transformer.word_embeddings.weight"] = g(V, d)
        sd["transformer.position_embeddings.weight"] = g(s + 1, d)
        sd["mixins.block_position_embedding.block_position_embeddings.weight"] = g(s + 1, d)
        return (sd, J.glmblock_params_from_sat, J.GLMBlockConfig(**kw), J.glmblock_forward,
                P.glmblock_from_sat, P.GLMBlockConfig(**kw), P.GLMBlock,
                (ids, _positions_2d(b, s), mask))
    from scail_tpu.models.zoo import cuda2d as J
    from scail_tpu_torch.models.zoo import cuda2d as P

    layout = (4, 20, 84)  # 4 text + a 4x4 level-0 grid, an 8x8 level-1 grid
    kw = dict(vocab_size=V, dim=d, num_heads=4, num_layers=L, max_len=21,
              new_sequence_length=21 + 64, layout=layout, kernel_size=3, kernel_size2=3)
    sd = _sat_block(rng, L, d, 4 * d, 4 * d)
    for i in range(L):
        sd[f"mixins.attention_plus.query_key_value.{i}.weight"] = g(3 * d, d)
        sd[f"mixins.attention_plus.query_key_value.{i}.bias"] = g(3 * d)
        sd[f"mixins.attention_plus.dense.{i}.weight"] = g(d, d)
        sd[f"mixins.attention_plus.dense.{i}.bias"] = g(d)
    sd["transformer.word_embeddings.weight"] = g(V, d)
    sd["transformer.position_embeddings.weight"] = g(21, d)
    sd["mixins.extra_position_embedding.position_embeddings.weight"] = g(64, d)
    ids = rng.integers(0, V, (1, 84))
    pos = np.concatenate([np.arange(20), np.arange(64)])[None]
    mask = np.tril(np.ones((1, 20, 20), np.float32))
    return (sd, J.cuda2d_params_from_sat, J.Cuda2dConfig(**kw), J.cuda2d_forward,
            P.cuda2d_from_sat, P.Cuda2dConfig(**kw), P.Cuda2d, (ids, pos, mask))


@pytest.mark.parametrize("name", ["chatglm", "chatglm2", "chatglm3", "glm130b", "glm130b_1d",
                                  "glmblock", "cuda2d"])
def test_sat_models_match_jax(name):
    import jax.numpy as jnp

    sd, jconv, jcfg, jfwd, pconv, pcfg, pcls, args = _sat_case(name, np.random.default_rng(5))
    jparams = jconv(sd, jcfg)
    port_sd = pconv({k: _t(v) for k, v in sd.items()}, pcfg)
    _same(port_sd, _bridge(name)(jparams))
    model = pcls(pcfg)
    model.load_state_dict(port_sd)
    with torch.no_grad():
        got = model(*(_t(a) for a in args))
    got = got[0] if isinstance(got, tuple) else got
    want = _jit(jfwd, jcfg)(jparams, *(jnp.asarray(a) for a in args))
    _close(got, want)


# --------------------------------------------------------------------------
# JAX inits through the bridge, KV caches, prefix tuning
# --------------------------------------------------------------------------
def _init_case(name):
    import jax

    key = jax.random.PRNGKey(0)
    if name == "llama":
        from scail_tpu.models.zoo import llama as J
        from scail_tpu_torch.models.zoo import llama as P

        kw = dict(vocab_size=64, dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
                  inner_hidden_size=48, max_len=16)
        jcfg = J.LlamaConfig(**kw)
        params = jax.jit(lambda k: J.init_llama_params(k, jcfg))(key)
        fwd, model = J.llama_forward, P.Llama(P.LlamaConfig(**kw))
    elif name == "gpt":
        from scail_tpu.models.zoo import gpt as J
        from scail_tpu_torch.models.zoo import gpt as P

        kw = dict(vocab_size=97, dim=32, num_heads=4, num_layers=2, max_len=16)
        jcfg = J.GPTConfig(**kw)
        params = jax.jit(lambda k: J.init_gpt_params(k, jcfg))(key)
        fwd, model = J.gpt_forward, P.GPT(P.GPTConfig(**kw))
    elif name == "glm":
        from scail_tpu.models.zoo import glm as J
        from scail_tpu_torch.models.zoo import glm as P

        kw = dict(vocab_size=64, dim=32, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
                  inner_hidden_size=48, max_len=16)
        jcfg = J.GlmConfig(**kw)
        params = jax.jit(lambda k: J.init_glm_params(k, jcfg))(key)
        fwd, model = J.glm_forward, P.Glm(P.GlmConfig(**kw))
    else:
        from scail_tpu.models.zoo import chatglm23 as J
        from scail_tpu_torch.models.zoo import chatglm23 as P

        kw = dict(vocab_size=64, dim=32, num_heads=4, num_kv_heads=2, num_layers=2,
                  inner_hidden_size=48, max_len=16)
        jcfg = J.ChatGLM2Config(**kw)
        params = jax.jit(lambda k: J.init_chatglm2_params(k, jcfg))(key)
        fwd, model = J.chatglm2_forward, P.ChatGLM2(P.ChatGLM2Config(**kw))
    model.load_state_dict(_bridge(name)(params))
    return jcfg, params, fwd, model


@pytest.mark.parametrize("name", ["llama", "gpt", "glm", "chatglm2"])
def test_cached_decode_matches_full_recompute_and_jax(name):
    """The JAX init through the bridge: the full forward equals JAX's; a
    prefill of 5 then 3 one-token steps through the cache equals the full
    forward (1e-5) and JAX's own cached decode; greedy tokens are equal."""
    import jax.numpy as jnp

    jcfg, params, fwd, model = _init_case(name)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 8))
    with torch.no_grad():
        full = model(_t(toks))[0]
        cache = model.new_cache(2)
        chunks = [model(_t(toks[:, :5]), cache=cache)[0]]
        for i in range(5, 8):
            chunks.append(model(_t(toks[:, i:i + 1]), cache=cache)[0])
    inc = torch.cat(chunks, dim=1)
    assert cache.length == 8
    _close(full, _jit(fwd, jcfg)(params, jnp.asarray(toks, jnp.int32)))
    _close(inc, full, 1e-5)
    assert torch.equal(inc.argmax(-1), full.argmax(-1))


def test_prefix_tuning_matches_jax_and_trains_only_the_prefix():
    """GPT with a learned KV prefix equals gpt_forward(prefix=...); LLaMA's
    cached decode with the prefix equals its full forward; the prefix-only
    optimizer moves the prefix and leaves the base bit-equal."""
    import jax
    import jax.numpy as jnp

    from scail_tpu.models.zoo import llama as JL
    from scail_tpu.training.prefix_tuning import init_prefix_params as jax_init_prefix
    from scail_tpu_torch.models.zoo import llama as PL
    from scail_tpu_torch.training.prefix_tuning import init_prefix_params, prefix_only_optimizer

    jcfg, params, fwd, model = _init_case("gpt")
    prefix = np.asarray(jax_init_prefix(jax.random.PRNGKey(1), 2, 4, 3, 8))
    toks = np.random.default_rng(2).integers(0, 97, (2, 6))
    with torch.no_grad():
        got = model(_t(toks), prefix=_t(prefix))[0]
        base = model(_t(toks))[0]
    _close(got, jax.jit(lambda p, t, x: fwd(p, jcfg, t, prefix=x)[0])(
        params, jnp.asarray(toks, jnp.int32), jnp.asarray(prefix)))
    assert (got - base).abs().max() > 1e-6

    holder = torch.nn.Module()
    holder.base = model
    holder.prefix = init_prefix_params(torch.Generator().manual_seed(1), 2, 4, 3, 8)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    p0 = holder.prefix.detach().clone()
    opt = prefix_only_optimizer(lambda p: torch.optim.SGD(p, lr=0.1), holder.named_parameters())
    model(_t(toks), prefix=holder.prefix)[0].square().mean().backward()
    opt.step()
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert (holder.prefix - p0).abs().sum() > 0

    kw = dict(vocab_size=40, dim=16, num_layers=2, num_heads=4, num_kv_heads=2,
              inner_hidden_size=24, max_len=10)
    lcfg = JL.LlamaConfig(**kw)
    lparams = jax.jit(lambda k: JL.init_llama_params(k, lcfg))(jax.random.PRNGKey(0))
    lmodel = PL.Llama(PL.LlamaConfig(**kw))
    lmodel.load_state_dict(_bridge("llama")(lparams))
    lprefix = _t(np.asarray(jax_init_prefix(jax.random.PRNGKey(1), 2, 2, 2, 4)))
    ltoks = _t(np.random.default_rng(3).integers(0, 40, (1, 6)))
    with torch.no_grad():
        full = lmodel(ltoks, prefix=lprefix)[0]
        cache = lmodel.new_cache(1)
        inc = torch.cat([lmodel(ltoks[:, :4], cache, prefix=lprefix)[0]]
                        + [lmodel(ltoks[:, i:i + 1], cache, prefix=lprefix)[0]
                           for i in range(4, 6)], dim=1)
    _close(inc, full, 1e-5)
    _close(full, jax.jit(lambda p, t, x: JL.llama_forward(p, lcfg, t, prefix=x)[0])(
        lparams, jnp.asarray(ltoks.numpy()), jnp.asarray(lprefix.numpy())))


# --------------------------------------------------------------------------
# Generation
# --------------------------------------------------------------------------
def _table_lm(vocab=11, seed=4):
    """A deterministic LM from numpy tables, the same function in both
    frameworks: logits = A[token at pos] + B[pos]."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((vocab, vocab)).astype(np.float32) * 2.0
    B = rng.standard_normal((16, vocab)).astype(np.float32)

    def port(tokens, pos):
        return _t(A)[tokens[:, pos]] + _t(B)[pos]

    def jax_fn(tokens, pos):
        import jax.numpy as jnp

        return jnp.asarray(A)[tokens[:, pos]] + jnp.asarray(B)[pos]

    return port, jax_fn


@pytest.mark.parametrize("seq", [[[2, -1, -1, -1, -1, -1]], [[2, -1, 6, -1, 3, -1],
                                                           [5, 1, -1, -1, -1, -1]]])
def test_filling_sequence_greedy_matches_jax(seq):
    import jax
    import jax.numpy as jnp

    from scail_tpu.generation import BaseStrategy as JStrategy
    from scail_tpu.generation import filling_sequence as jax_fill
    from scail_tpu_torch.generation import BaseStrategy, filling_sequence

    port_lm, jax_lm = _table_lm()
    got = filling_sequence(port_lm, torch.tensor(seq), BaseStrategy(top_k=1),
                           torch.Generator().manual_seed(0))
    want = jax_fill(jax_lm, jnp.asarray(seq, jnp.int32), JStrategy(top_k=1),
                    key=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).all()


def test_filling_sequence_with_a_llama_matches_jax_greedy():
    """Greedy filling over the port's LLaMA (full recompute a step) gives
    JAX's tokens over llama_forward."""
    import jax
    import jax.numpy as jnp

    from scail_tpu.generation import BaseStrategy as JStrategy
    from scail_tpu.generation import filling_sequence as jax_fill
    from scail_tpu_torch.generation import BaseStrategy, filling_sequence

    jcfg, params, fwd, model = _init_case("llama")
    seq = np.full((2, 12), -1, np.int64)
    seq[:, :4] = np.random.default_rng(6).integers(0, 64, (2, 4))

    def port_lm(tokens, pos):
        with torch.no_grad():
            return model(tokens[:, :pos + 1].clamp(min=0))[0][:, -1]

    jfull = _jit(fwd, jcfg)

    def jax_lm(tokens, pos):
        full = jfull(params, jnp.maximum(tokens, 0))
        return jax.lax.dynamic_index_in_dim(full, pos, axis=1, keepdims=False)

    got = filling_sequence(port_lm, _t(seq), BaseStrategy(top_k=1))
    want = jax_fill(jax_lm, jnp.asarray(seq, jnp.int32), JStrategy(top_k=1),
                    key=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [dict(top_k=3), dict(top_p=0.6), dict(top_k=5, top_p=0.8,
                                                                      temperature=0.7)])
def test_top_k_top_p_masks_and_draws(kw):
    """The port's mask keeps exactly the tokens JAX's sampler ever draws (400
    draws, one jitted vmap), and the port's 4,000 draws a row (one batched
    call) follow softmax(mask) within 0.03."""
    import jax
    import jax.numpy as jnp

    from scail_tpu.generation import BaseStrategy as JStrategy
    from scail_tpu_torch.generation import BaseStrategy

    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 12)).astype(np.float32)
    strat, jstrat = BaseStrategy(**kw), JStrategy(**kw)
    masked = strat.mask(_t(logits))
    keep = torch.isfinite(masked).numpy()
    draws = np.asarray(jax.jit(jax.vmap(lambda k: jstrat.forward(jnp.asarray(logits), k)))(
        jax.random.split(jax.random.PRNGKey(0), 400)))
    for r in range(2):
        assert set(np.flatnonzero(keep[r])) == set(draws[:, r].tolist()), r
    g = torch.Generator().manual_seed(0)
    port_draws = strat.forward(_t(logits).repeat(4000, 1), g).reshape(4000, 2)
    probs = torch.softmax(masked, dim=-1).numpy()
    for r in range(2):
        freq = np.bincount(port_draws[:, r].numpy(), minlength=12) / 4000
        assert np.abs(freq - probs[r]).max() < 0.03
        assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(keep[r]))


@pytest.mark.parametrize("num_beams,length_penalty", [(3, 1.0), (4, 0.5)])
def test_beam_search_matches_jax(num_beams, length_penalty):
    import jax.numpy as jnp

    from scail_tpu.generation import BeamSearchStrategy as JBeam
    from scail_tpu_torch.generation import BeamSearchStrategy

    port_lm, jax_lm = _table_lm(seed=9)
    got = BeamSearchStrategy(num_beams=num_beams, length_penalty=length_penalty).search(
        port_lm, torch.tensor([4]), 5)
    want = JBeam(num_beams=num_beams, length_penalty=length_penalty).search(
        jax_lm, jnp.asarray([4], jnp.int32), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the JAX package's own case: a flat LM favouring token 1
    flat = BeamSearchStrategy(num_beams=3).search(
        lambda t, p: torch.zeros(t.shape[0], 5).index_fill(1, torch.tensor([1]), 2.0),
        torch.tensor([4]), 4)
    assert flat.tolist() == [4, 1, 1, 1, 1]


def test_gpt_generate_greedy_matches_jax():
    import jax
    import jax.numpy as jnp

    from scail_tpu.models.zoo.gpt import generate as jax_generate
    from scail_tpu_torch.models.zoo.gpt import generate

    jcfg, params, fwd, model = _init_case("gpt")
    prompt = np.random.default_rng(1).integers(0, 97, (2, 3))
    got = generate(model, _t(prompt), 6, torch.Generator().manual_seed(1), top_k=1)
    again = generate(model, _t(prompt), 6, torch.Generator().manual_seed(1), top_k=1)
    want = jax.jit(lambda p, x, k: jax_generate(p, jcfg, x, 6, k, top_k=1))(
        params, jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(1))
    assert got.shape == (2, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, again)
