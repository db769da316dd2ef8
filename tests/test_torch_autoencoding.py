"""The port's autoencoder training stack against the JAX package, on the CPU.

Same seeds, same inputs (numpy), f32; the weights carried across by the
JAX package's torch loaders (vqmodel_params_from_torch,
nlayer_discriminator_params_from_torch, video_tokenizer_params_from_torch)
reading the port's state dicts, or by convert/from_jax.py.  Modules at
rtol 2e-4 / atol 1e-4, losses 1e-5, parameters after an Adam step 1e-6;
indices equal.

* VQ (values, indices, gradients), EMA-VQ (the buffers after an update),
  LFQ with and without projections and with two codebooks, its entropy
  terms unchunked and in chunks of tokens (values and gradients).
* VQModel and MOVQ: encode, decode, forward, decode_code, codebook_stats;
  the JAX loader on the port's state dict; the bridge back bit-equal.
* NLayerDiscriminator (batch statistics) and the video discriminator (an
  odd frame count raises on both sides; the first frame dropped, as phase
  13 feeds a 17-frame clip).
* LPIPSWithDiscriminator (generator and discriminator losses, the adaptive
  weight, gradients, the disc_start gate) and VideoAutoencoderLoss (the
  adversarial term's polarity, the gradient penalty).
* One AutoencoderTrainer generator step and one discriminator step on a
  tiny VQModel with a perceptual term: every parameter after the update.
* The video tokenizer: encode, quantize, decode, the padding contract,
  indices round trip, gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scail_tpu.autoencoding as J
from scail_tpu.autoencoding.discriminator import nlayer_discriminator_params_from_torch
from scail_tpu.autoencoding.video_tokenizer import VideoTokenizer as JaxTokenizer
from scail_tpu.autoencoding.video_tokenizer import VideoTokenizerConfig as JaxTokConfig
from scail_tpu.autoencoding.video_tokenizer import video_tokenizer_params_from_torch
from scail_tpu.autoencoding.vqgan import MOVQ as JaxMOVQ
from scail_tpu.autoencoding.vqgan import VQModel as JaxVQModel
from scail_tpu.autoencoding.vqgan import (_conv2d, _swish, _normalize, decoder_apply,
                                          encoder_apply, vqmodel_params_from_torch)
from scail_tpu_torch.autoencoding import (LFQ, AutoencoderTrainer, EMAVectorQuantizer,
                                          LPIPSWithDiscriminator, NLayerDiscriminator,
                                          VectorQuantizer, VideoAutoencoderLoss,
                                          VideoDiscriminator, lfq_entropy_terms,
                                          measure_perplexity)
from scail_tpu_torch.autoencoding import regularizers
from scail_tpu_torch.autoencoding.video_tokenizer import VideoTokenizer, VideoTokenizerConfig
from scail_tpu_torch.autoencoding.vqgan import MOVQ, VQModel
from scail_tpu_torch.convert.from_jax import (ema_quantizer_state_dict_from_jax,
                                              lfq_state_dict_from_jax,
                                              nlayer_discriminator_state_dict_from_jax,
                                              video_discriminator_state_dict_from_jax,
                                              video_tokenizer_state_dict_from_jax,
                                              vqmodel_state_dict_from_jax)

MOD = dict(rtol=2e-4, atol=1e-4)
LOSS = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _last(t):
    """(b, c, ...) torch -> (b, ..., c) numpy."""
    return t.detach().movedim(1, -1).numpy()


def _first(a):
    """(b, ..., c) numpy / jax -> (b, c, ...) torch."""
    return torch.from_numpy(np.moveaxis(np.array(a, np.float32), -1, 1).copy())


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _close(got, want, tol=MOD):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), **tol)


def _rel_close(got, want, tol=2e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= tol, rel


# ---------------------------------------------------------------------------
# regularizers
# ---------------------------------------------------------------------------
def test_vector_quantizer_matches_jax():
    rng = np.random.default_rng(0)
    vq = VectorQuantizer(16, 4, beta=0.3, log_perplexity=True).init_random_(_gen(0))
    emb = vq.embedding.weight.detach().numpy().copy()
    z = rng.standard_normal((2, 4, 5, 3)).astype(np.float32) * 0.1
    w = rng.standard_normal(z.shape).astype(np.float32)

    def jloss(p, zl):
        zq, log = J.vector_quantize(p, zl, beta=0.3, log_perplexity=True)
        return log["loss/vq"] + jnp.sum(zq * jnp.asarray(np.moveaxis(w, 1, -1))), (zq, log)

    (jl, (jzq, jlog)), (jg_p, jg_z) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {"embedding": jnp.asarray(emb)}, jnp.asarray(np.moveaxis(z, 1, -1)))
    zt = _t(z).requires_grad_(True)
    zq, log = vq(zt)
    loss = log["loss/vq"] + (zq * _t(w)).sum()
    loss.backward()
    _close(_last(zq), jzq)
    _close(loss.item(), jl, LOSS)
    assert np.array_equal(log["min_encoding_indices"].numpy(),
                          np.asarray(jlog["min_encoding_indices"]))
    _close(log["perplexity"].item(), jlog["perplexity"], LOSS)
    assert int(log["cluster_usage"]) == int(jlog["cluster_usage"])
    _close(_last(zt.grad), jg_z)
    _close(vq.embedding.weight.grad.numpy(), jg_p["embedding"])
    idx = rng.integers(0, 10, size=(3, 7))
    p, c = measure_perplexity(torch.from_numpy(idx), 10)
    jp, jc = J.measure_perplexity(jnp.asarray(idx), 10)
    _close(p.item(), jp, LOSS)
    assert int(c) == int(jc)


def test_ema_quantizer_matches_jax_and_updates_its_buffers():
    rng = np.random.default_rng(1)
    state = J.init_ema_quantizer(jax.random.PRNGKey(0), 12, 4)
    q = EMAVectorQuantizer(12, 4, beta=0.25, decay=0.9)
    q.load_state_dict(ema_quantizer_state_dict_from_jax(state))
    z = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    for _ in range(2):  # two updates: the second starts from the first's buffers
        jzq, jlog, state = J.ema_vector_quantize(state, jnp.asarray(np.moveaxis(z, 1, -1)),
                                                 beta=0.25, decay=0.9)
        zq, log = q(_t(z))
        _close(_last(zq), jzq)
        _close(log["loss/vq"].item(), jlog["loss/vq"], LOSS)
        _close(log["perplexity"].item(), jlog["perplexity"], LOSS)
        assert np.array_equal(log["encoding_indices"].numpy(), np.asarray(jlog["encoding_indices"]))
        for k in ("weight", "cluster_size", "embed_avg"):
            _close(getattr(q.embedding, k).numpy(), state[k], dict(rtol=1e-6, atol=1e-6))
        z = z * 0.5 + 0.3
    q.eval()
    before = q.embedding.weight.clone()
    q(_t(z))
    assert torch.equal(before, q.embedding.weight)  # eval mode: no update
    assert not any(p.requires_grad for p in q.parameters())


LFQ_CASES = {"projected": dict(dim=12, codebook_size=2 ** 8),
             "bare": dict(dim=None, codebook_size=2 ** 6),
             "two_codebooks": dict(dim=10, codebook_size=2 ** 5, num_codebooks=2)}


@pytest.mark.parametrize("case", list(LFQ_CASES))
def test_lfq_matches_jax_chunked_and_unchunked(case, monkeypatch):
    kw = LFQ_CASES[case]
    rng = np.random.default_rng(2)
    params = J.init_lfq(jax.random.PRNGKey(1), **kw)
    lfq_kw = dict(codebook_size=kw["codebook_size"], num_codebooks=kw.get("num_codebooks", 1),
                  diversity_gamma=2.5, entropy_loss_weight=0.1, commitment_loss_weight=1.0)
    dim = kw["dim"] or int(np.log2(kw["codebook_size"]))
    x = rng.standard_normal((2, 3, 4, dim)).astype(np.float32) * 0.05
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jfn(p, xx):
        q, idx, aux, br = J.lfq_quantize(p, xx, **lfq_kw)
        return aux + jnp.sum(q * jnp.asarray(w)), (q, idx, aux, br)

    (_, (jq, jidx, jaux, jbr)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    outs = {}
    per_token = lfq_kw["num_codebooks"] * lfq_kw["codebook_size"]
    for chunk in (None, 5):
        # LFQ picks its chunk from LFQ_CHUNK_ELEMENTS: the default keeps these
        # 24 tokens whole, a limit of 5 tokens' probabilities chunks them by 5
        if chunk is not None:
            monkeypatch.setattr(regularizers, "LFQ_CHUNK_ELEMENTS", chunk * per_token)
        assert regularizers.lfq_auto_chunk(x.size // dim, lfq_kw["num_codebooks"],
                                           lfq_kw["codebook_size"]) == chunk
        m = LFQ(dim=kw["dim"], **lfq_kw)
        m.load_state_dict(lfq_state_dict_from_jax(params))
        xt = _t(x).requires_grad_(True)
        q, idx, aux, br = m.quantize(xt)
        (aux + (q * _t(w)).sum()).backward()
        outs[chunk] = (q.detach(), idx, aux.item(), {k: v.item() for k, v in br.items()},
                       xt.grad, [p.grad.clone() for p in m.parameters()])
        _close(q.detach().numpy(), jq)
        assert np.array_equal(idx.numpy(), np.asarray(jidx))
        _close(aux.item(), jaux, LOSS)
        for k in ("per_sample_entropy", "batch_entropy", "commitment"):
            _close(br[k].item(), jbr[k], LOSS)
        _close(xt.grad.numpy(), jgx)
        if "project_in" in jgp:
            _close(m.project_in.weight.grad.numpy(), np.asarray(jgp["project_in"]["kernel"]).T)
    # chunked against unchunked: the same function
    a, b = outs[None], outs[5]
    _close(b[2], a[2], dict(rtol=1e-6, atol=1e-7))
    # gradients: f32 sums in another order, scaled by inv_temperature 100
    _close(b[4].numpy(), a[4].numpy(), dict(rtol=1e-4, atol=1e-5))
    for ga, gb in zip(a[5], b[5]):
        _close(gb.numpy(), ga.numpy(), dict(rtol=1e-4, atol=1e-5))


def test_lfq_entropy_terms_chunked_gradient_covers_the_clip():
    """Confident tokens put most codes under the 1e-5 clip: the chunked
    gradient must treat the clipped ones as JAX's clip does."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((37, 2, 6)).astype(np.float32) * 0.05)
    from scail_tpu_torch.autoencoding.regularizers import lfq_codebook

    cb = lfq_codebook(64)
    res = []
    for chunk in (None, 4, 37):
        xt = x.clone().requires_grad_(True)
        ps, be = lfq_entropy_terms(xt, cb, 100.0, chunk)
        (0.7 * ps - 2.5 * be).backward()
        res.append((ps.item(), be.item(), xt.grad))

    def jfn(xx):
        prob = jax.nn.softmax(2.0 * 100.0 * jnp.einsum("nkd,cd->nkc", xx, jnp.asarray(cb.numpy())))
        ent = lambda p: jnp.sum(-p * jnp.log(jnp.clip(p, 1e-5, None)), axis=-1)  # noqa: E731
        return 0.7 * ent(prob).mean() - 2.5 * ent(prob.mean(0)).mean()

    jg = jax.grad(jfn)(jnp.asarray(x.numpy()))
    for ps, be, g in res:
        _close(g.numpy(), jg, dict(rtol=1e-4, atol=1e-5))
        _close(ps, res[0][0], dict(rtol=1e-6, atol=1e-7))
        _close(be, res[0][1], dict(rtol=1e-6, atol=1e-7))


# ---------------------------------------------------------------------------
# VQModel / MOVQ
# ---------------------------------------------------------------------------
DD = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
          in_channels=3, resolution=16, z_channels=8, double_z=False, dropout=0.0)


@pytest.mark.parametrize("movq", [False, True], ids=["vqmodel", "movq"])
def test_vq_shells_match_jax(movq):
    cls, jcls = (MOVQ, JaxMOVQ) if movq else (VQModel, JaxVQModel)
    model = cls(DD, n_embed=16, embed_dim=4).init_random_(_gen(3))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = vqmodel_params_from_torch(sd, DD, movq=movq)
    jm = jcls(DD, 16, 4)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        quant, diff, idx = model.encode(_first(x))
        jq, jdiff, jidx = jm.encode(params, jnp.asarray(x))
        _close(_last(quant), jq)
        _close(diff.item(), jdiff, LOSS)
        assert np.array_equal(idx.numpy(), np.asarray(jidx))
        dec, d2 = model(_first(x))
        jdec, _ = jm(params, jnp.asarray(x))
        _close(_last(dec), jdec)
        _close(_last(model.decode_code(idx)), jm.decode_code(params, jnp.asarray(idx.numpy())))
        p, c = model.codebook_stats(_first(x))
        jp, jc = jm.codebook_stats(params, jnp.asarray(x))
        _close(p.item(), jp, LOSS)
        assert int(c) == int(jc)
    # the bridge back: the JAX tree into the port's names, bit-equal
    back = vqmodel_state_dict_from_jax(params, movq=movq)
    assert set(back) == set(model.state_dict())
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    if movq:
        assert "decoder.mid.block_1.norm1.conv_y.weight" in back
        assert "decoder.norm_out.norm_layer.weight" in back


def test_vq_models_resolve_under_the_reference_names():
    from scail_tpu_torch.utils.registry import instantiate_from_config

    for name, cls in (("VQModel", VQModel), ("MOVQ", MOVQ)):
        m = instantiate_from_config({"target": f"sgm.models.vqgan.{name}", "params": dict(
            ddconfig=DD, n_embed=8, embed_dim=4)})
        assert type(m) is cls


# ---------------------------------------------------------------------------
# discriminators
# ---------------------------------------------------------------------------
def test_nlayer_discriminator_matches_jax():
    d = NLayerDiscriminator(3, ndf=8, n_layers=2).init_random_(_gen(5))
    sd0 = {k: v.clone() for k, v in d.state_dict().items()}
    params = nlayer_discriminator_params_from_torch({k: v.numpy() for k, v in sd0.items()},
                                                    n_layers=2)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    xt = _first(x).requires_grad_(True)
    y = d(xt)
    w = rng.standard_normal(y.shape).astype(np.float32)
    (y * _t(w)).sum().backward()

    def jfn(p, xx):
        out = J.nlayer_discriminator(p, xx)
        return jnp.sum(out * jnp.asarray(np.moveaxis(w, 1, -1))), out

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    _close(_last(y), jy)
    _close(_last(xt.grad), jgx)
    _close(d.main[3].weight.grad.numpy(), jgp["layers"][1]["bn"]["scale"])
    # the JAX parameters back through the bridge: the same state dict, bit for
    # bit (JAX's loader above read it; its eager init would cost seconds of
    # op-by-op compiles)
    back = nlayer_discriminator_state_dict_from_jax(params)
    assert back.keys() == sd0.keys()
    for k, v in sd0.items():
        assert torch.equal(torch.as_tensor(np.asarray(back[k])), v), k


@functools.lru_cache(maxsize=None)
def _jax_video_disc(**kw):
    """JAX's init, once a configuration (its eager ops compile one by one)."""
    return J.init_video_discriminator(jax.random.PRNGKey(0), **kw)


def _video_pair(**kw):
    jp = _jax_video_disc(**kw)
    d = VideoDiscriminator(**kw)
    d.load_state_dict(video_discriminator_state_dict_from_jax(jp))
    return jp, d


@pytest.mark.parametrize("kw", [dict(dim=4, image_size=16, frame_num=4),
                                dict(dim=4, image_size=32, frame_num=2)],
                         ids=["all_3d", "2d_tail"])
def test_video_discriminator_matches_jax(kw):
    jp, d = _video_pair(**kw)
    rng = np.random.default_rng(6)
    n = kw["frame_num"]
    x = rng.uniform(-1, 1, (2, n, kw["image_size"], kw["image_size"], 3)).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3))).requires_grad_(True)
    y = d(xt)
    y.sum().backward()
    def jfn(b0, xx):  # the first block's parameters (the tree also holds an int)
        out = J.video_discriminator({**jp, "blocks": [b0] + jp["blocks"][1:]}, xx)
        return jnp.sum(out), out

    (_, jy), (jg0, jgx) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        jp["blocks"][0], jnp.asarray(x))
    _close(y.detach().numpy(), jy)
    _close(xt.grad.numpy().transpose(0, 2, 3, 4, 1), jgx)
    _close(d.blocks[0].conv1.weight.grad.numpy(),
           np.asarray(jg0["conv1"]["kernel"]).transpose(4, 3, 0, 1, 2))


def test_video_discriminator_odd_frames_raise_and_the_first_frame_dropped_matches_jax():
    kw = dict(dim=4, image_size=16, frame_num=4)
    jp, d = _video_pair(**kw)
    x = np.random.default_rng(7).uniform(-1, 1, (1, 5, 16, 16, 3)).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))
    with pytest.raises(TypeError):
        J.video_discriminator(jp, jnp.asarray(x))
    with pytest.raises(ValueError, match="even"):
        d(xt)
    with torch.no_grad():  # the clip after its first frame: what phase 13 feeds
        _close(d(xt[:, :, 1:]).numpy(), J.video_discriminator(jp, jnp.asarray(x[:, 1:])))


# ---------------------------------------------------------------------------
# GAN losses
# ---------------------------------------------------------------------------
# a cheap perceptual distance, the same on both sides (the losses take any
# (x, y) -> (b,) callable; LPIPS itself is held in test_torch_evals.py, and
# chip_smoke phase 13 trains with it)
def _percep_jax(a, b):  # channels last
    return jnp.mean((jnp.tanh(2.0 * a) - jnp.tanh(2.0 * b)) ** 2, axis=(1, 2, 3))


def _percep_torch(a, b):  # channels first
    return torch.mean((torch.tanh(2.0 * a) - torch.tanh(2.0 * b)) ** 2, dim=(1, 2, 3))


def _jax_head(w, feats):
    return jax.lax.conv_general_dilated(feats, w, (1, 1), "VALID",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("percep", [False, True], ids=["l1", "perceptual"])
def test_lpips_with_discriminator_matches_jax(percep):
    rng = np.random.default_rng(8)
    disc = NLayerDiscriminator(3, ndf=8, n_layers=2).init_random_(_gen(8))
    dparams = nlayer_discriminator_params_from_torch(
        {k: v.numpy() for k, v in disc.state_dict().items()}, n_layers=2)
    feats = rng.standard_normal((2, 5, 16, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 5, 1, 1)) * 0.2).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    kl = np.float32(0.37)
    common = dict(disc_start=10, disc_weight=0.7, perceptual_weight=1.0 if percep else 0.0,
                  regularization_weights={"kl_loss": 0.3})
    jloss = J.LPIPSWithDiscriminator(**common, lpips_fn=_percep_jax if percep else None)
    ploss = LPIPSWithDiscriminator(**common, lpips=_percep_torch if percep else None)
    head = torch.nn.Conv2d(5, 3, 1, bias=False)
    with torch.no_grad():
        head.weight.copy_(_t(w))
    wj = jnp.asarray(w.transpose(2, 3, 1, 0))
    fj = jnp.asarray(feats.transpose(0, 2, 3, 1))
    for step in (25, 3):
        def jfn(ww, ff):
            recon = _jax_head(ww, ff)
            return jloss.generator_loss(dparams, jnp.asarray(0.17),
                                        jnp.asarray(np.moveaxis(x, 1, -1)),
                                        recon, {"kl_loss": jnp.asarray(kl)}, step,
                                        adaptive_ctx=(_jax_head, ww, ff))

        (jv, jlog), (jgw, jgf) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1),
                                                            has_aux=True))(wj, fj)
        ft = _t(feats).requires_grad_(True)
        head.zero_grad()
        loss, log = ploss.generator_loss(disc, torch.tensor(0.17), _t(x), head(ft),
                                         {"kl_loss": torch.tensor(kl)}, step,
                                         adaptive_ctx=(head, ft))
        loss.backward()
        _close(loss.item(), jv, dict(rtol=1e-5, atol=1e-5))
        for k in ("loss/nll", "loss/g", "loss/percep", "scalars/d_weight"):
            _close(float(log[k]), jlog[k], dict(rtol=1e-4, atol=1e-6))
        assert (float(log["scalars/d_weight"]) > 0) == (step >= 10)
        _close(head.weight.grad.numpy(), np.asarray(jgw).transpose(3, 2, 0, 1))
        _close(ft.grad.numpy(), np.asarray(jgf).transpose(0, 3, 1, 2))
        assert all(p.grad is None for p in disc.parameters())  # nothing leaks into the critic
    for kind in ("hinge", "vanilla"):
        jl2 = J.LPIPSWithDiscriminator(disc_start=10, disc_factor=0.8, disc_loss=kind)
        pl2 = LPIPSWithDiscriminator(disc_start=10, disc_factor=0.8, disc_loss=kind)
        r = x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
        for step in (3, 25):
            jd, jdl = jl2.discriminator_loss(dparams, jnp.asarray(np.moveaxis(x, 1, -1)),
                                             jnp.asarray(np.moveaxis(r, 1, -1)), step)
            pd, pdl = pl2.discriminator_loss(disc, _t(x), _t(r), step)
            _close(pd.item(), jd, LOSS)
            _close(pdl["logits/real"].item(), jdl["logits/real"], MOD)


def test_video_autoencoder_loss_matches_jax():
    kw = dict(dim=4, image_size=16, frame_num=4)
    jp, disc = _video_pair(**kw)
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (2, 4, 16, 16, 3)).astype(np.float32)
    r = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    fi = np.asarray(jax.random.randint(key, (2,), 0, 4))
    common = dict(disc_start=5, perceptual_weight=0.5, adversarial_loss_weight=0.2,
                  grad_penalty_loss_weight=10.0, quantizer_aux_loss_weight=0.5)
    jloss = J.VideoAutoencoderLoss(**common, lpips_fn=_percep_jax)
    ploss = VideoAutoencoderLoss(**common, lpips=_percep_torch)

    def to_t(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 4, 1, 2, 3)))

    # the reconstruction through a 1x1x1 head on features: the adaptive weight
    feats = rng.standard_normal((2, 4, 16, 16, 5)).astype(np.float32)
    w = (rng.standard_normal((5, 3)) * 0.3).astype(np.float32)
    head = torch.nn.Conv3d(5, 3, 1, bias=False)
    with torch.no_grad():
        head.weight.copy_(_t(w.T[:, :, None, None, None]))

    def jhead(ww, ff):
        return ff @ ww

    def jfn(ff, step):
        return jloss.generator_loss(jp, jnp.asarray(x), jhead(jnp.asarray(w), ff), step, key=key,
                                    aux_losses=jnp.asarray(0.3),
                                    adaptive_ctx=(jhead, jnp.asarray(w), ff))

    (jv, jlog), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True), static_argnums=1)(
        jnp.asarray(feats), 10)
    ft = to_t(feats).requires_grad_(True)
    total, log = ploss.generator_loss(disc, to_t(x), head(ft), 10, aux_losses=torch.tensor(0.3),
                                      frame_indices=torch.from_numpy(fi),
                                      adaptive_ctx=(head, ft))
    total.backward()
    _close(total.item(), jv, LOSS)
    for k in ("recon_loss", "perceptual_loss", "gen_loss"):
        _close(float(log[k]), jlog[k], LOSS)
    _close(float(log["adaptive_weight"]), jlog["adaptive_weight"], dict(rtol=1e-4, atol=1e-6))
    assert float(log["gen_loss"]) != 0.0 and float(log["adaptive_weight"]) > 0.0
    _rel_close(ft.grad.numpy().transpose(0, 2, 3, 4, 1), jg)
    assert all(p.grad is None for p in disc.parameters())
    with torch.no_grad():  # before disc_start the adversarial term is off, as in JAX
        _, log2 = ploss.generator_loss(disc, to_t(x), to_t(r), 2, aux_losses=torch.tensor(0.3),
                                       frame_indices=torch.from_numpy(fi))
    _, jlog2 = jloss.generator_loss(jp, jnp.asarray(x), jnp.asarray(r), 2, key=key,
                                    aux_losses=jnp.asarray(0.3))
    assert float(log2["gen_loss"]) == 0.0 == float(jlog2["gen_loss"])
    _close(float(log2["total_loss"]), jlog2["total_loss"], LOSS)

    def jdisc(b0):
        return jloss.discriminator_loss({**jp, "blocks": [b0] + jp["blocks"][1:]},
                                        jnp.asarray(x), jnp.asarray(r), 10)

    (jd, jdl), jgd = jax.jit(jax.value_and_grad(jdisc, has_aux=True))(jp["blocks"][0])
    d, dl = ploss.discriminator_loss(disc, to_t(x), to_t(r), 10)
    d.backward()
    _close(d.item(), jd, LOSS)
    _close(dl["grad_penalty_loss"].item(), jdl["grad_penalty_loss"], LOSS)
    _close(disc.blocks[0].conv1.weight.grad.numpy(),
           np.asarray(jgd["conv1"]["kernel"]).transpose(4, 3, 0, 1, 2), MOD)


# ---------------------------------------------------------------------------
# AutoencoderTrainer: one generator and one discriminator step
# ---------------------------------------------------------------------------
TRAIN_DD = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                in_channels=3, resolution=16, z_channels=4, double_z=False, dropout=0.0)


def _jax_vq_trainer(params, dparams, loss_obj, movq=False):
    """The JAX AutoencoderTrainer over VQModel's pieces: conv_out is the head."""
    dec = dict(params["decoder"])
    head = dec.pop("conv_out")

    def encoder(p, x):
        return _conv2d(p["quant_conv"], encoder_apply(p["encoder"], x), padding=((0, 0), (0, 0)))

    def regularizer(rp, z, key):
        return J.vector_quantize(rp, z)

    def body(p, z):
        h = _conv2d(p["post_quant_conv"], z, padding=((0, 0), (0, 0)))
        h = decoder_apply(p["dec"], h, zq=z if movq else None, give_pre_end=True)
        return _swish(_normalize(p["dec"]["norm_out"], h, z if movq else None))

    def head_apply(hp, feats):
        return _conv2d(hp, feats)

    tr = J.AutoencoderTrainer(encoder_apply=encoder, decoder_body=body, decoder_head=head_apply,
                              loss=loss_obj, regularizer=regularizer,
                              disc_apply=J.nlayer_discriminator, ae_lr=1e-3, disc_lr=2e-3)
    ae = {"encoder": {"encoder": params["encoder"], "quant_conv": params["quant_conv"]},
          "regularizer": params["quantize"],
          "decoder": {"dec": dec, "post_quant_conv": params["post_quant_conv"]},
          "decoder_head": head}
    return tr, tr.init_state(ae, dparams)


def test_autoencoder_trainer_steps_match_jax():
    model = VQModel(TRAIN_DD, n_embed=8, embed_dim=4).init_random_(_gen(10))
    disc = NLayerDiscriminator(3, ndf=8, n_layers=1).init_random_(_gen(11))
    params = vqmodel_params_from_torch({k: v.numpy() for k, v in model.state_dict().items()},
                                       TRAIN_DD)
    dparams = nlayer_discriminator_params_from_torch(
        {k: v.numpy() for k, v in disc.state_dict().items()}, n_layers=1)
    common = dict(disc_start=0, disc_weight=0.5, regularization_weights={"loss/vq": 1.0})
    jloss = J.LPIPSWithDiscriminator(**common, lpips_fn=_percep_jax)
    jtr, state = _jax_vq_trainer(params, dparams, jloss)
    ae0 = state["gen"]["ae"]
    ptr = AutoencoderTrainer(**model.trainer_parts(),
                             loss=LPIPSWithDiscriminator(**common, lpips=_percep_torch),
                             discriminator=disc, ae_lr=1e-3, disc_lr=2e-3)
    x = np.random.default_rng(12).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    emb0 = model.quantize.embedding.weight.detach().clone()
    steps = [jax.jit(f, static_argnames="global_step")
             for f in (jtr.generator_step, jtr.discriminator_step)]
    for batch_idx in (0, 1):
        state, jv, jlog = steps[batch_idx](state, jnp.asarray(x), key, global_step=5)
        pv, plog = ptr.train_step(_first(x), None, batch_idx, 5)
        _close(pv.item(), jv, dict(rtol=1e-5, atol=1e-5))
    assert not torch.equal(emb0, model.quantize.embedding.weight)  # the codebook trains
    # Adam's first step is lr g / (|g| + eps): a gradient within rounding of 0
    # moves by a fraction of lr, so atol is 1% of the discriminator's lr
    tol = dict(rtol=1e-5, atol=2e-5)

    def as_ae(sd):
        """A VQModel state dict in the JAX trainer's ae layout."""
        p = vqmodel_params_from_torch(sd, TRAIN_DD)
        dec = dict(p["decoder"])
        head = dec.pop("conv_out")
        return {"encoder": {"encoder": p["encoder"], "quant_conv": p["quant_conv"]},
                "regularizer": p["quantize"],
                "decoder": {"dec": dec, "post_quant_conv": p["post_quant_conv"]},
                "decoder_head": head}

    def by_path(tree):
        return {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    sd = model.state_dict(keep_vars=True)
    got = by_path(as_ae({k: v.detach().numpy() for k, v in sd.items()}))
    # Adam's first moment after one step is (1 - b1) g: both sides' gradients
    pgrad = by_path(as_ae({k: (ptr.opt_gen.state[v]["exp_avg"] / 0.1).numpy()
                           if v in ptr.opt_gen.state else np.zeros(v.shape, np.float32)
                           for k, v in sd.items()}))
    want, init = by_path(state["gen"]["ae"]), by_path(ae0)
    jgrad = {k: v / 0.1 for k, v in by_path(state["opt_gen"][0].mu["ae"]).items()}
    assert got.keys() == want.keys() == jgrad.keys() == pgrad.keys()
    scale = max(np.abs(g).max() for g in jgrad.values())
    null = [k for k, g in jgrad.items() if np.abs(g).max() <= 1e-6 * scale]
    # a per-channel constant ahead of a one-channel-per-group GroupNorm (the
    # first encoder block's conv1 bias, the biases of the last decoder level
    # ahead of norm_out) and the attention's key bias get no gradient: the
    # norm and the softmax remove them.  Adam's first step moves such a leaf
    # by up to lr on rounding noise, so it is held to a zero gradient on both
    # sides and to that step instead
    assert null and all("bias" in k for k in null), null
    for k in want:
        if k in null:
            assert np.abs(pgrad[k]).max() <= 1e-6 * scale, k
            assert np.abs(got[k] - init[k]).max() <= 1e-3 * (1 + 1e-5), k
        else:
            _close(got[k], want[k], tol)
    _close(ptr.model.logvar.item(), state["gen"]["logvar"], tol)  # learn_logvar off
    dgot = nlayer_discriminator_params_from_torch(
        {k: v.detach().numpy() for k, v in disc.state_dict().items()}, n_layers=1)
    for a, b in zip(jax.tree.leaves(dgot), jax.tree.leaves(state["disc"])):
        _close(a, b, tol)
    # the gate: before disc_start every batch trains the generator
    gated = AutoencoderTrainer(**model.trainer_parts(), loss=LPIPSWithDiscriminator(
        disc_start=100), discriminator=disc, disc_start=100)
    d0 = disc.main[0].weight.detach().clone()
    gated.train_step(_first(x), None, 1, 5)
    assert torch.equal(d0, disc.main[0].weight)


def test_autoencoder_trainer_with_the_ema_quantizer_and_the_video_loss():
    """The EMA codebook moves in the generator's forward; the tokenizer trains
    through VideoAutoencoderLoss with the first frame dropped for the 3D
    discriminator (the phase 13 composition, tiny)."""
    from scail_tpu_torch.autoencoding.discriminator import VideoDiscriminator as VD

    tok = VideoTokenizer(VideoTokenizerConfig(layers=("residual", "compress_space",
                                                      "compress_time"),
                                              init_dim=8, codebook_size=2 ** 6))
    tok.init_random_(_gen(13))

    class AfterFirst(torch.nn.Module):
        def __init__(self, d):
            super().__init__()
            self.d = d

        def forward(self, x):
            return self.d(x[:, :, 1:])

    disc = AfterFirst(VD(dim=4, image_size=16, frame_num=4).init_random_(_gen(14)))
    tr = AutoencoderTrainer(**tok.trainer_parts(), loss=VideoAutoencoderLoss(
        disc_start=0, adversarial_loss_weight=0.1, quantizer_aux_loss_weight=1.0,
        perceptual_weight=0.0), discriminator=disc)
    v = torch.from_numpy(np.random.default_rng(15).uniform(-1, 1, (1, 3, 5, 16, 16))
                         .astype(np.float32))
    g = _gen(0)
    w0 = tok.conv_in.conv.weight.detach().clone()
    d0 = disc.d.blocks[0].conv1.weight.detach().clone()
    for i in range(2):
        loss, log = tr.train_step(v, g, i, 1)
        assert torch.isfinite(loss)
    assert not torch.equal(w0, tok.conv_in.conv.weight)
    assert not torch.equal(d0, disc.d.blocks[0].conv1.weight)
    ema = EMAVectorQuantizer(8, 4, beta=0.25).init_random_(_gen(16))
    w = ema.embedding.weight.clone()
    vq = VQModel(TRAIN_DD, n_embed=8, embed_dim=4).init_random_(_gen(17))
    parts = dict(vq.trainer_parts(), regularizer=ema)
    etr = AutoencoderTrainer(**parts, loss=LPIPSWithDiscriminator(
        disc_start=0, perceptual_weight=0.0, regularization_weights={"loss/vq": 1.0}),
        discriminator=NLayerDiscriminator(3, 8, 1).init_random_(_gen(18)))
    loss, _ = etr.train_step(torch.rand(2, 3, 16, 16) * 2 - 1, None, 0, 0)
    assert torch.isfinite(loss) and not torch.equal(w, ema.embedding.weight)


# ---------------------------------------------------------------------------
# the video tokenizer
# ---------------------------------------------------------------------------
TOK_LAYERS = ("residual", "compress_space", ("consecutive_residual", 2), "compress_time",
              "residual")


@pytest.fixture(scope="module")
def tokenizers():
    """The port's random tokenizer, and the JAX one on its weights through the
    JAX package's torch loader."""
    jt = JaxTokenizer(JaxTokConfig(layers=TOK_LAYERS, init_dim=8, channels=3,
                                   codebook_size=256))
    pt = VideoTokenizer(VideoTokenizerConfig(layers=TOK_LAYERS, init_dim=8, channels=3,
                                             codebook_size=256)).init_random_(_gen(21))
    params = video_tokenizer_params_from_torch(
        {k: v.numpy() for k, v in pt.state_dict().items()}, jt)
    return jt, params, pt


def _ncthw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 4, 1, 2, 3)))


def _nthwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 4, 1)


def test_video_tokenizer_matches_jax(tokenizers):
    jt, params, pt = tokenizers
    assert pt.latent_dim == jt.latent_dim == 32 and pt.time_padding == 1
    v = np.random.default_rng(19).standard_normal((1, 5, 16, 16, 3)).astype(np.float32)
    vt = _ncthw(v).requires_grad_(True)
    recon, aux, log = pt(vt)
    assert recon.shape == vt.shape  # the padding contract: 5 frames in, 5 out
    w = np.random.default_rng(20).standard_normal(recon.shape).astype(np.float32)
    ((recon * _t(w)).sum() + aux).backward()

    def jfn(vv):
        r, a, lg = jt(params, vv, training=True)
        return jnp.sum(r * jnp.asarray(w.transpose(0, 2, 3, 4, 1))) + a, (r, a, lg)

    (_, (jr, ja, jlog)), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(v))
    with torch.no_grad():
        feats = pt.encode(_ncthw(v))
    _close(_nthwc(feats), jt.encode(params, jnp.asarray(v)))
    assert feats.shape == (1, 32, 3, 8, 8)
    _close(_nthwc(recon), jr)
    _close(aux.item(), ja, LOSS)
    assert np.array_equal(log["indices"].numpy(), np.asarray(jlog["indices"]))
    for k in ("per_sample_entropy", "batch_entropy", "commitment"):
        _close(log[k].item(), jlog[k], LOSS)
    _close(_nthwc(vt.grad), jg)
    with torch.no_grad():
        idx = pt.tokenize(_ncthw(v))
        assert np.array_equal(idx.numpy(), np.asarray(jt.tokenize(params, jnp.asarray(v))))
        _close(_nthwc(pt.decode_from_indices(idx)),
               jt.decode_from_indices(params, jnp.asarray(idx.numpy())))
        _close(_nthwc(pt.decode_from_indices(idx)), _nthwc(pt(_ncthw(v), training=False)[0]))


def test_tokenizer_bridge_inverts_the_jax_loader(tokenizers):
    """from_jax(the JAX loader's tree of the port's state dict) is that state
    dict again, bit for bit, name for name."""
    jt, params, pt = tokenizers
    sd = pt.state_dict()
    back = video_tokenizer_state_dict_from_jax(jax.tree.map(np.asarray, params), pt.plan)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    fresh = VideoTokenizer(VideoTokenizerConfig(layers=TOK_LAYERS, init_dim=8,
                                                codebook_size=256)).init_random_(_gen(0))
    se = fresh.encoder_layers[0].fn[4].net[2]
    assert torch.all(se.weight == 0) and torch.all(se.bias == -10.0)
