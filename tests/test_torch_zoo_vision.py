"""The port's vision encoders (ViT, CaiT, EVA-02, EVA-CLIP, GLM-4V, MAE,
YOLOS) against the JAX package, on the CPU, f32.

Each model: its released-layout converter (`*_from_hf` on a tiny HF model
that `transformers` builds, or `*_from_sat` on a SAT-layout state dict this
file writes) equals the JAX converter through the weight bridge, exactly;
the forward on those weights equals the JAX forward within 1e-4; the HF ones
also HF's outputs within 2e-4 (YOLOS away from its trained grid 5e-4: the
JAX tests' bounds).  MAE's loss is held within 1e-5 and its parameter
gradients within 1e-4, with and without norm_pix, on noise with ties.
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


def _jit(fwd, cfg, **kw):
    import jax

    return jax.jit(lambda params, *args: fwd(params, cfg, *args, **kw))


def _bridge(params):
    from scail_tpu_torch.convert.from_jax import encoder_state_dict_from_jax

    return encoder_state_dict_from_jax(params)


def _drawn(hf, seed):
    """HF's state dict with every bias and LayerNorm weight drawn, loaded back."""
    g = torch.Generator().manual_seed(seed)
    sd = _sd(hf)
    with torch.no_grad():
        for k, v in sd.items():
            if k.endswith(".bias") or "layernorm" in k.lower() or "norm.weight" in k:
                v.add_(0.05 * torch.randn(v.shape, generator=g))
    hf.load_state_dict(sd, strict=False)
    return sd


def _sat(rng, shapes):
    """A SAT-layout state dict: {name: shape}; LayerNorm weights near one."""
    sd = {}
    for k, shape in shapes.items():
        a = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if k.endswith("layernorm.weight") or ".ffn_ln." in k and k.endswith("weight"):
            a += 1.0
        sd[k] = a
    return sd


def _sat_layers(L, d, f, fmt="transformer.layers.{}.", mlp_in=None):
    shapes = {}
    for i in range(L):
        p = fmt.format(i)
        for ln in ("input_layernorm", "post_attention_layernorm"):
            shapes[p + ln + ".weight"] = shapes[p + ln + ".bias"] = (d,)
        for name, (o, i_) in {"attention.query_key_value": (3 * d, d),
                              "attention.dense": (d, d), "mlp.dense_h_to_4h": (mlp_in or f, d),
                              "mlp.dense_4h_to_h": (d, f)}.items():
            shapes[p + name + ".weight"], shapes[p + name + ".bias"] = (o, i_), (o,)
    return shapes


# --------------------------------------------------------------------------
# HF-layout models
# --------------------------------------------------------------------------
def test_vit_matches_jax_and_hf():
    import transformers as tf

    from scail_tpu.models.zoo import vit as J
    from scail_tpu_torch.models.zoo import vit as P

    torch.manual_seed(2)
    hf = tf.ViTForImageClassification(tf.ViTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=48,
        image_size=32, patch_size=16, num_labels=7, hidden_act="gelu", layer_norm_eps=1e-12,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)).eval()
    sd = _drawn(hf, 2)
    kw = dict(image_size=32, patch_size=16, dim=32, num_heads=4, num_layers=2,
              inner_hidden_size=48, num_classes=7)
    jcfg, pcfg = J.ViTConfig(**kw), P.ViTConfig(**kw)
    jparams = J.vit_params_from_hf(_np(sd), jcfg)
    port_sd = P.vit_from_hf(sd, pcfg)
    _same(port_sd, _bridge(jparams))
    model = P.ViT(pcfg, device="cpu")
    model.load_state_dict(port_sd)
    imgs = np.random.default_rng(2).standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = model(_t(imgs))
        want_hf = hf(_t(imgs)).logits
    _close(got, _jit(J.vit_forward, jcfg)(jparams, imgs))
    _close(got, want_hf, 2e-4)


MAE_KW = dict(image_size=32, patch_size=8, dim=32, num_heads=4, num_layers=2,
              inner_hidden_size=48, decoder_dim=24, decoder_num_heads=4, decoder_num_layers=2,
              decoder_inner_hidden_size=40, mask_ratio=0.75)


@pytest.fixture(scope="module")
def mae_case():
    import transformers as tf

    from scail_tpu.models.zoo import mae as J
    from scail_tpu_torch.models.zoo import mae as P

    torch.manual_seed(5)
    hf = tf.ViTMAEForPreTraining(tf.ViTMAEConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=48,
        image_size=32, patch_size=8, num_channels=3, decoder_hidden_size=24,
        decoder_num_hidden_layers=2, decoder_num_attention_heads=4, decoder_intermediate_size=40,
        mask_ratio=0.75, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        norm_pix_loss=False)).eval()
    sd = _drawn(hf, 5)
    jcfg, pcfg = J.MAEConfig(**MAE_KW), P.MAEConfig(**MAE_KW)
    jparams = J.mae_params_from_hf(_np(sd), jcfg)
    port_sd = P.mae_from_hf(sd, pcfg)
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    # a coarse noise: ties, which a stable argsort orders by index as jnp.argsort does
    noise = (rng.integers(0, 5, (2, pcfg.num_patches)) / 5.0).astype(np.float32)
    return hf, jcfg, jparams, pcfg, port_sd, imgs, noise


def test_mae_matches_jax_and_hf(mae_case):
    """Converter, forward (logits, mask, ids_restore) against JAX, logits and
    mask against HF on the same noise, and HF's loss."""
    from scail_tpu.models.zoo import mae as J
    from scail_tpu_torch.models.zoo import mae as P

    hf, jcfg, jparams, pcfg, port_sd, imgs, noise = mae_case
    _same(port_sd, _bridge(jparams))
    model = P.MAE(pcfg, device="cpu")
    model.load_state_dict(port_sd)
    with torch.no_grad():
        logits, mask, ids_restore = model(_t(imgs), _t(noise))
        out = hf(_t(imgs), noise=_t(noise))
    jl, jm, jr = _jit(J.mae_forward, jcfg)(jparams, imgs, noise)
    _close(logits, jl)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ids_restore.numpy(), np.asarray(jr))
    _close(logits, out.logits, 2e-4)
    np.testing.assert_array_equal(mask.numpy(), out.mask.numpy())
    with torch.no_grad():
        loss = P.mae_loss(model, _t(imgs), _t(noise))
    np.testing.assert_allclose(float(loss), float(out.loss), rtol=1e-4)


@pytest.mark.parametrize("norm_pix", [False, True])
def test_mae_loss_and_gradients_match_jax(mae_case, norm_pix):
    import jax

    from scail_tpu.models.zoo import mae as J
    from scail_tpu_torch.models.zoo import mae as P

    _, jcfg, jparams, pcfg, port_sd, imgs, noise = mae_case
    model = P.MAE(pcfg, device="cpu")
    model.load_state_dict(port_sd)
    model.requires_grad_(True)
    loss = P.mae_loss(model, _t(imgs), _t(noise), norm_pix=norm_pix)
    loss.backward()
    loss = loss.detach()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: J.mae_loss(p, jcfg, imgs, noise, norm_pix=norm_pix)))(jparams)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    want = _bridge(jgrads)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        _close(g, want[k])
    assert any(float(g.abs().sum()) > 0 for g in grads.values())


def test_yolos_matches_jax_and_hf():
    """At the trained grid, then at twice it, where the position tables are
    resized with JAX's bicubic matrices."""
    import transformers as tf

    from scail_tpu.models.zoo import yolos as J
    from scail_tpu_torch.models.zoo import yolos as P

    torch.manual_seed(6)
    hf = tf.YolosForObjectDetection(tf.YolosConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=48,
        image_size=[32, 48], patch_size=16, num_detection_tokens=5, num_labels=2,
        use_mid_position_embeddings=True, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)).eval()
    sd = _drawn(hf, 6)
    kw = dict(image_size=(32, 48), patch_size=16, dim=32, num_heads=4, num_layers=2,
              inner_hidden_size=48, num_detection_tokens=5, num_labels=2)
    jcfg, pcfg = J.YolosConfig(**kw), P.YolosConfig(**kw)
    jparams = J.yolos_params_from_hf(_np(sd), jcfg)
    port_sd = P.yolos_from_hf(sd, pcfg)
    _same(port_sd, _bridge(jparams))
    model = P.Yolos(pcfg, device="cpu")
    model.load_state_dict(port_sd)
    rng = np.random.default_rng(6)
    fwd = _jit(J.yolos_forward, jcfg)
    for shape, hf_tol in (((2, 3, 32, 48), 2e-4), ((1, 3, 64, 96), 5e-4)):
        imgs = rng.standard_normal(shape).astype(np.float32)
        with torch.no_grad():
            logits, boxes = model(_t(imgs))
            out = hf(_t(imgs))
        jl, jb = fwd(jparams, imgs)
        _close(logits, jl)
        _close(boxes, jb)
        _close(logits, out.logits, hf_tol)
        _close(boxes, out.pred_boxes, hf_tol)


# --------------------------------------------------------------------------
# SAT-layout models
# --------------------------------------------------------------------------
def test_cait_matches_jax():
    """Talking heads (the head mixes on the f32 scores and probabilities),
    LayerScale, two class-attention stages."""
    from scail_tpu.models.zoo import cait as J
    from scail_tpu_torch.models.zoo import cait as P

    kw = dict(image_size=32, patch_size=8, dim=32, num_heads=4, num_layers=2,
              dec_num_layers=2, inner_hidden_size=48, num_classes=10)
    jcfg, pcfg = J.CaiTConfig(**kw), P.CaiTConfig(**kw)
    d, f, n, L = 32, 48, 4, 2
    shapes = {"encoder.mixins.patch_embedding.proj.weight": (d, 3, 8, 8),
              "encoder.mixins.patch_embedding.proj.bias": (d,),
              "encoder.transformer.word_embeddings.weight": (1, d),
              "encoder.transformer.position_embeddings.weight": (17, d),
              "decoder.transformer.word_embeddings.weight": (1, d),
              "decoder.transformer.final_layernorm.weight": (d,),
              "decoder.transformer.final_layernorm.bias": (d,),
              "decoder.mixins.cls.classifier.weight": (10, d),
              "decoder.mixins.cls.classifier.bias": (10,)}
    shapes.update(_sat_layers(L, d, f, "encoder.transformer.layers.{}."))
    for i in range(L):
        for m in ("proj_l", "proj_w"):
            shapes[f"encoder.mixins.attn.{m}.{i}.weight"] = (n, n)
            shapes[f"encoder.mixins.attn.{m}.{i}.bias"] = (n,)
        for side in ("encoder.mixins.enc_forward", "decoder.mixins.dec_forward"):
            shapes[f"{side}.gamma_1.{i}"] = shapes[f"{side}.gamma_2.{i}"] = (d,)
        p = f"decoder.transformer.layers.{i}."
        for name, shape in {"input_layernorm": (d,), "post_cross_attention_layernorm": (d,),
                            "cross_attention.query": (d, d),
                            "cross_attention.key_value": (2 * d, d),
                            "cross_attention.dense": (d, d), "mlp.dense_h_to_4h": (f, d),
                            "mlp.dense_4h_to_h": (d, f)}.items():
            shapes[p + name + ".weight"], shapes[p + name + ".bias"] = shape, shape[:1]
    rng = np.random.default_rng(11)
    sd = _sat(rng, shapes)
    jparams = J.cait_params_from_sat(sd, jcfg)
    port_sd = P.cait_from_sat({k: _t(v) for k, v in sd.items()}, pcfg)
    _same(port_sd, _bridge(jparams))
    model = P.CaiT(pcfg, device="cpu")
    model.load_state_dict(port_sd)
    imgs = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = model(_t(imgs))
    _close(got, _jit(J.cait_forward, jcfg)(jparams, imgs))


def test_eva2_matches_jax():
    """The vision rotary tables equal JAX's; the forward with half the
    patches masked."""
    from scail_tpu.models.zoo import eva2 as J
    from scail_tpu_torch.models.zoo import eva2 as P

    kw = dict(image_size=28, patch_size=7, dim=32, num_heads=4, num_layers=2,
              inner_hidden_size=40, predict_feature_dim=24)
    jcfg, pcfg = J.EVA2Config(**kw), P.EVA2Config(**kw)
    d, f, L = 32, 40, 2
    shapes = {"mixins.patch_embedding.proj.weight": (d, 3, 7, 7),
              "mixins.patch_embedding.proj.bias": (d,),
              "mixins.patch_embedding.mask_token": (1, 1, d),
              "transformer.word_embeddings.weight": (1, d),
              "transformer.position_embeddings.weight": (17, d),
              "transformer.final_layernorm.weight": (d,), "transformer.final_layernorm.bias": (d,),
              "mixins.eva2-final.lm_head.weight": (24, d), "mixins.eva2-final.lm_head.bias": (24,)}
    shapes.update(_sat_layers(L, d, f))
    for i in range(L):
        m = "mixins.eva2-mlp."
        shapes[f"{m}w2.{i}.weight"], shapes[f"{m}w2.{i}.bias"] = (f, d), (f,)
        shapes[f"{m}ffn_ln.{i}.weight"] = shapes[f"{m}ffn_ln.{i}.bias"] = (f,)
    rng = np.random.default_rng(12)
    sd = _sat(rng, shapes)
    jparams = J.eva2_params_from_sat(sd, jcfg)
    port_sd = P.eva2_from_sat({k: _t(v) for k, v in sd.items()}, pcfg)
    _same(port_sd, _bridge(jparams))
    for got, want in zip(P.vision_rope_tables(pcfg.head_dim, pcfg.grid),
                         J._vision_rope_tables(jcfg)):
        np.testing.assert_array_equal(got, np.asarray(want))
    model = P.EVA2(pcfg, device="cpu")
    model.load_state_dict(port_sd)
    imgs = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    masked = rng.random((2, 16)) < 0.5
    with torch.no_grad():
        got = model(_t(imgs), _t(masked))
    _close(got, _jit(J.eva2_forward, jcfg)(jparams, imgs, masked))


def _evaclip_shapes(d, f, L, grid, patch, prefix=""):
    shapes = {"mixins.patch_embedding.proj.weight": (d, 3, patch, patch),
              "mixins.patch_embedding.proj.bias": (d,),
              "transformer.word_embeddings.weight": (1, d),
              "transformer.position_embeddings.weight": (grid * grid + 1, d),
              "transformer.final_layernorm.weight": (d,), "transformer.final_layernorm.bias": (d,)}
    shapes.update(_sat_layers(L, d, f))
    return {prefix + k: v for k, v in shapes.items()}


def test_evaclip_matches_jax():
    from scail_tpu.models.zoo import evaclip as J
    from scail_tpu_torch.models.zoo import evaclip as P

    kw = dict(image_size=32, patch_size=8, dim=32, num_heads=4, num_layers=2,
              inner_hidden_size=48, eps=1e-6)
    jcfg, pcfg = J.EVACLIPConfig(**kw), P.EVACLIPConfig(**kw)
    rng = np.random.default_rng(13)
    sd = _sat(rng, _evaclip_shapes(32, 48, 2, 4, 8))
    jparams = J.evaclip_params_from_sat(sd, jcfg)
    port_sd = P.evaclip_from_sat({k: _t(v) for k, v in sd.items()}, pcfg)
    _same(port_sd, _bridge(jparams))
    model = P.EVACLIP(pcfg, device="cpu")
    model.load_state_dict(port_sd)
    imgs = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = model(_t(imgs))
    assert got.shape == (2, 16, 32)
    _close(got, _jit(J.evaclip_forward, jcfg)(jparams, imgs))


def test_glm4v_matches_jax():
    """The EVA-CLIP tower and the adapter from SAT files, GLM-4 from JAX's
    init: the whole tree through the bridge; the logits with the image rows
    spliced at the mask, and text alone."""
    import jax
    import jax.numpy as jnp

    from scail_tpu.models.zoo import evaclip as JE
    from scail_tpu.models.zoo import glm as JG
    from scail_tpu.models.zoo import glm4v as J
    from scail_tpu_torch.models.zoo import evaclip as PE
    from scail_tpu_torch.models.zoo import glm as PG
    from scail_tpu_torch.models.zoo import glm4v as P

    gkw = dict(vocab_size=64, dim=24, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
               inner_hidden_size=40, max_len=32)
    vkw = dict(image_size=16, patch_size=4, dim=16, num_heads=4, num_layers=2,
               inner_hidden_size=24, eps=1e-6)
    akw = dict(proj_hidden_size=20, adapter_inner=40)
    jcfg = J.GLM4VConfig(glm=JG.GlmConfig(**gkw), vit=JE.EVACLIPConfig(**vkw), **akw)
    pcfg = P.GLM4VConfig(glm=PG.GlmConfig(**gkw), vit=PE.EVACLIPConfig(**vkw), **akw)
    assert pcfg.image_length == jcfg.image_length == 6
    rng = np.random.default_rng(17)
    a = "mixins.eva."
    sd = _sat(rng, {**_evaclip_shapes(16, 24, 2, 4, 4, prefix="vit."),
                    a + "conv.weight": (20, 16, 2, 2), a + "conv.bias": (20,),
                    a + "linear_proj.linear_proj.weight": (24, 20),
                    a + "linear_proj.norm1.weight": (24,), a + "linear_proj.norm1.bias": (24,),
                    a + "linear_proj.gate_proj.weight": (40, 24),
                    a + "linear_proj.dense_h_to_4h.weight": (40, 24),
                    a + "linear_proj.dense_4h_to_h.weight": (24, 40),
                    a + "boi": (1, 1, 24), a + "eoi": (1, 1, 24)})
    tsd = {k: _t(v) for k, v in sd.items()}
    vit_sd = {k[4:]: v for k, v in sd.items() if k.startswith("vit.")}
    jparams = {"glm": jax.jit(lambda k: JG.init_glm_params(k, jcfg.glm))(jax.random.PRNGKey(0)),
               "vit": JE.evaclip_params_from_sat(vit_sd, jcfg.vit),
               "adapter": J.glm4v_adapter_params_from_sat(sd)}
    bridged = _bridge(jparams)
    _same({f"adapter.{k}": v for k, v in P.glm4v_adapter_from_sat(tsd).items()},
          {k: v for k, v in bridged.items() if k.startswith("adapter.")})
    tvit = {k: _t(v) for k, v in vit_sd.items()}
    _same({f"vit.{k}": v for k, v in PE.evaclip_from_sat(tvit, pcfg.vit).items()},
          {k: v for k, v in bridged.items() if k.startswith("vit.")})
    model = P.GLM4V(pcfg, device="cpu")
    model.load_state_dict(bridged)
    b, s = 2, 12
    toks = rng.integers(0, 64, (b, s))
    mask = np.zeros((b, s), bool)
    mask[0, 2:8] = True
    mask[1, 5:11] = True
    imgs = rng.standard_normal((b, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        got = model(_t(toks), _t(imgs), _t(mask))[0]
        text = model(_t(toks))[0]
    fwd = jax.jit(lambda p, t, i, m: J.glm4v_forward(p, jcfg, t, images=i,
                                                     image_embed_mask=m)[0])
    _close(got, fwd(jparams, jnp.asarray(toks, jnp.int32), imgs, mask))
    _close(text, jax.jit(lambda p, t: J.glm4v_forward(p, jcfg, t)[0])(
        jparams, jnp.asarray(toks, jnp.int32)))
    _close(got[0, :2], text[0, :2], 1e-5)  # causal: the rows before the image
