"""The port's tokenizers, adapters, MLP head and distillation against the
JAX package, on the CPU, f32.

Tokenizers: the GPT-2 BPE, WordPiece and GLM command-token layers give the
JAX package's ids, tokens and decodes exactly, on vocab and merges files
this file writes; `get_tokenizer` dispatches, caches and raises as JAX's
does; the image tokenizer's codes over a tiny VQModel equal JAX's and its
decode is held within 1e-4.  Training helpers: the GPT with adapters equals
`gpt_forward(adapters=...)` within 1e-4; one adapters-only or student-only
SGD step equals optax's within 1e-6 while every frozen tensor stays
bit-equal; the MLP head and kd_loss equal JAX's.
"""

import json

import numpy as np
import pytest
import torch

SAMPLES = [
    "Hello world!",
    "  leading spaces and   runs",
    "don't stop: it's 2026, prices rose 3.5%!",
    "unicode naïve café ünïcode 汉字 test",
    "CamelCase hyphen-ated under_scored",
    "newline\nand\ttab",
    "hello [MASK] world <|endoftext|> the end",
]


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    """A miniature GPT-2 vocab (the 256 byte symbols and merges that fire)
    and a BERT vocab.txt."""
    from scail_tpu_torch.tokenization.text import bytes_to_unicode

    d = tmp_path_factory.mktemp("vocab")
    b2u = bytes_to_unicode()
    symbols = [b2u[i] for i in range(256)]
    merges = ["#version: 0.2"]
    sp = b2u[ord(" ")]
    for a, b in [("h", "e"), ("l", "l"), ("ll", "o"), ("w", "o"), ("wo", "r"), ("wor", "l"),
                 ("worl", "d"), ("t", "h"), ("th", "e"), (sp, "t"), (sp + "t", "he")]:
        merges.append(f"{a} {b}")
        symbols.append(a + b)
    symbols += ["<|endoftext|>"]
    vf, mf, bf = d / "vocab.json", d / "merges.txt", d / "vocab.txt"
    vf.write_text(json.dumps({s: i for i, s in enumerate(symbols)}))
    mf.write_text("\n".join(merges) + "\n")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words += list("abcdefghijklmnopqrstuvwxyz0123456789.,!?'-%:")
    words += ["hello", "world", "don", "stop", "it", "the", "##s", "##t", "##ed", "##ing",
              "##ld", "un", "##der", "test", "and", "new", "##line", "tab", "ca", "##fe",
              "naive", "prices", "rose", "汉", "字"]
    bf.write_text("\n".join(words) + "\n")
    return str(vf), str(mf), str(bf)


# --------------------------------------------------------------------------
# text tokenizers
# --------------------------------------------------------------------------
def test_gpt2_bpe_and_wordpiece_match_jax(vocab):
    from scail_tpu.tokenization import text as J
    from scail_tpu_torch.tokenization import text as P

    vf, mf, bf = vocab
    assert P.bytes_to_unicode() == J.bytes_to_unicode()
    pairs = ((P.GPT2BPE(vf, mf), J.GPT2BPE(vf, mf)),
             (P.WordPiece(bf, do_lower_case=True), J.WordPiece(bf, do_lower_case=True)))
    for ours, theirs in pairs:
        assert len(ours) == len(theirs) and ours.tokens == theirs.tokens
        for s in SAMPLES:
            ids = ours.encode(s)
            assert ids == theirs.encode(s), s
            assert ours.decode(ids) == theirs.decode(ids), s
            if hasattr(theirs, "tokenize"):
                assert ours.tokenize(s) == theirs.tokenize(s), s
    bpe = P.GPT2BPE(vf, mf)
    assert all(bpe.decode(bpe.encode(s)) == s for s in SAMPLES)  # byte level: exact inverse


@pytest.mark.parametrize("kind", ["gpt2", "wordpiece"])
def test_glm_tokenizers_match_jax(vocab, kind):
    """Command-token layouts (block symbols, task masks, the decoder mask),
    the command split, EncodeAsIds / EncodeAsTokens / DecodeIds / IdToToken."""
    from scail_tpu.tokenization import glm as J
    from scail_tpu_torch.tokenization import glm as P

    vf, mf, bf = vocab
    kw = dict(add_block_symbols=True, add_task_mask=True, add_decoder_mask=True)
    if kind == "gpt2":
        ours, theirs = P.GPT2BPETokenizer(vf, mf, **kw), J.GPT2BPETokenizer(vf, mf, **kw)
    else:
        ours, theirs = P.BertWordPieceTokenizer(bf, **kw), J.BertWordPieceTokenizer(bf, **kw)
    assert len(ours) == len(theirs)
    assert ([(c.name, c.token, c.Id) for c in ours.command_tokens]
            == [(c.name, c.token, c.Id) for c in theirs.command_tokens])
    cases = SAMPLES + ["[MASK] leading", "trailing [MASK]", "a<|startofpiece|>b [gMASK] c",
                       "stacked [MASK] [MASK][sMASK]", "spaces around   [MASK]   left"]
    for s in cases:
        ids = ours.EncodeAsIds(s).tokenization
        assert ids == theirs.EncodeAsIds(s).tokenization, s
        assert ours.EncodeAsTokens(s).tokenization == theirs.EncodeAsTokens(s).tokenization, s
        assert ours.DecodeIds(ids) == theirs.DecodeIds(ids), s
        assert [ours.IdToToken(i) for i in ids] == [theirs.IdToToken(i) for i in ids], s
    t = ours.EncodeAsIds("hello")
    assert t.MASK == theirs.EncodeAsIds("hello").MASK == ours.get_command("MASK").Id


def test_get_tokenizer_dispatches_caches_and_raises_as_jax(vocab):
    import scail_tpu.tokenization as J
    import scail_tpu_torch.tokenization as P

    vf, mf, bf = vocab
    for mod in (P, J):
        assert mod.get_tokenizer(args={"tokenizer_type": "fake"}) is None
        a = {"tokenizer_type": "glm_GPT2BPETokenizer", "vocab_file": vf, "merges_file": mf,
             "task_mask": True}
        t1 = mod.get_tokenizer(args=a)
        assert mod.get_tokenizer(args=a) is t1 and mod.get_tokenizer() is t1
        sentinel = object()
        assert mod.get_tokenizer(outer_tokenizer=sentinel) is sentinel
        assert mod.get_tokenizer() is sentinel
        for bad, err in (("glm_ChineseSPTokenizer", ImportError), ("icetk", ImportError),
                         ("cogview_ICE", ImportError), ("nope", ValueError)):
            with pytest.raises(err):
                mod.get_tokenizer(args={"tokenizer_type": bad})
    b = {"tokenizer_type": "glm_BertWordPieceTokenizer", "vocab_file": bf,
         "tokenizer_model_type": "bert-base-uncased"}
    ours, theirs = P.get_tokenizer(args=b), J.get_tokenizer(args=b)
    assert type(ours).__module__.startswith("scail_tpu_torch.")
    for s in SAMPLES:
        assert ours.EncodeAsIds(s).tokenization == theirs.EncodeAsIds(s).tokenization, s


def test_image_tokenizer_codes_match_jax():
    """NHWC in and out; codes of a tiny VQModel equal JAX's on the same
    weights, the decode within 1e-4; the factory's `image` type wraps it."""
    import jax

    import scail_tpu_torch.tokenization as P
    from scail_tpu.autoencoding.vqgan import VQModel as JVQ
    from scail_tpu.autoencoding.vqgan import vqmodel_params_from_torch
    from scail_tpu.tokenization.image import ImageTokenizer as JTok
    from scail_tpu_torch.autoencoding.vqgan import VQModel
    from scail_tpu_torch.tokenization.image import ImageTokenizer, sqrt_int

    dd = dict(z_channels=6, resolution=16, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
              num_res_blocks=1, attn_resolutions=[])
    model = VQModel(dd, n_embed=24, embed_dim=6).init_random_(torch.Generator().manual_seed(0))
    params = vqmodel_params_from_torch({k: v.numpy() for k, v in model.state_dict().items()},
                                       dict(dd, double_z=False))
    ours, theirs = ImageTokenizer(model), JTok(JVQ(dd, n_embed=24, embed_dim=6), params)
    assert len(ours) == len(theirs) == 24
    img = np.random.default_rng(0).uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    ids = ours.EncodeAsIds(img, add_normalization=True)
    assert ids.shape == (2, 64) and 0 <= int(ids.min()) and int(ids.max()) < 24
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jax.jit(lambda x: theirs.EncodeAsIds(
                                      x, add_normalization=True))(img)))
    rec = ours.DecodeIds(ids[:1])
    assert rec.shape == (1, 16, 16, 3)
    _close(rec, jax.jit(theirs.DecodeIds)(ids[:1].numpy()))
    assert sqrt_int(64) == 8
    with pytest.raises(AssertionError):
        sqrt_int(50)
    assert P.get_tokenizer(args={"tokenizer_type": "image", "img_tokenizer_model": model,
                                 "img_tokenizer_params": model.state_dict()}).model is model


# --------------------------------------------------------------------------
# adapters, MLP head, distillation
# --------------------------------------------------------------------------
GPT_KW = dict(vocab_size=40, dim=16, num_heads=2, num_layers=2, max_len=12)


def _gpt_pair(seed):
    import jax

    from scail_tpu.models.zoo import gpt as J
    from scail_tpu_torch.convert.from_jax import gpt_state_dict_from_jax
    from scail_tpu_torch.models.zoo.gpt import GPT, GPTConfig

    params = J.init_gpt_params(jax.random.PRNGKey(seed), J.GPTConfig(**GPT_KW))
    model = GPT(GPTConfig(**GPT_KW))
    model.load_state_dict(gpt_state_dict_from_jax(params))
    return params, model


def _frozen_copy(module, key):
    return {k: v.detach().clone() for k, v in module.state_dict().items()
            if key not in k.split(".")}


def test_gpt_adapters_and_adapters_only_step_match_jax():
    """The forward with adapters (std 0.3, so they move the logits); one
    SGD step through adapters_only_optimizer: the adapters equal optax's
    within 1e-6, the base bit-equal."""
    import jax
    import jax.numpy as jnp
    import optax

    from scail_tpu.models.zoo.gpt import GPTConfig, gpt_forward
    from scail_tpu.training import adapters as JA
    from scail_tpu_torch.convert.from_jax import adapters_state_dict_from_jax
    from scail_tpu_torch.models.common import container
    from scail_tpu_torch.training import adapters as PA

    jcfg = GPTConfig(**GPT_KW)
    base, model = _gpt_pair(0)
    jad = JA.init_adapter_params(jax.random.PRNGKey(1), 2, 16, 4, std=0.3)
    ad = PA.Adapters(2, 16, 4, device="cpu")
    ad.load_state_dict(adapters_state_dict_from_jax(jad))
    rng = np.random.default_rng(3)
    toks, labels = rng.integers(0, 40, (2, 6)), rng.integers(0, 40, (2, 6))
    with torch.no_grad():
        got = model(_t(toks), adapters=ad)[0]
        plain = model(_t(toks))[0]
    want = jax.jit(lambda p, a, t: gpt_forward(p, jcfg, t, adapters=a)[0])(base, jad, toks)
    _close(got, want)
    assert float((got - plain).abs().max()) > 1e-3

    def loss(tree):
        logits, _ = gpt_forward(tree["base"], jcfg, toks, adapters=tree["adapters"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    tree = {"base": base, "adapters": jad}
    tx = JA.adapters_only_optimizer(optax.sgd(0.1))
    updates, _ = tx.update(jax.grad(loss)(tree), tx.init(tree), tree)
    new = optax.apply_updates(tree, updates)

    holder = container(base=model, adapters=ad)
    frozen = _frozen_copy(holder, "adapters")
    opt = PA.adapters_only_optimizer(lambda ps: torch.optim.SGD(ps, lr=0.1),
                                     holder.named_parameters())
    logits = model(_t(toks), adapters=ad)[0]
    torch.nn.functional.cross_entropy(logits.reshape(-1, 40), _t(labels).reshape(-1)).backward()
    opt.step()
    want = adapters_state_dict_from_jax(new["adapters"])
    for k, v in ad.state_dict().items():
        _close(v, want[k], 1e-6)
    assert not torch.equal(ad.layers[0].attn.down.weight, _t(jad["attn"]["down"]["kernel"][0]).T)
    for k, v in holder.state_dict().items():
        if k in frozen:
            assert torch.equal(v, frozen[k]), k


def test_adapter_init_and_mlp_head_match_jax():
    import jax
    import jax.numpy as jnp

    from scail_tpu.training import adapters as JA
    from scail_tpu_torch.convert.from_jax import mlp_head_state_dict_from_jax
    from scail_tpu_torch.training import adapters as PA

    ad = PA.init_adapter_params(torch.Generator().manual_seed(0), 3, 16, 4)
    sd = ad.state_dict()
    assert len(ad.layers) == 3 and sd["layers.2.mlp.up.weight"].shape == (16, 4)
    assert all(p.requires_grad for p in ad.parameters())
    assert all(float(v.abs().max()) == 0.0 for k, v in sd.items() if k.endswith("bias"))
    assert 5e-4 < float(sd["layers.0.attn.down.weight"].std()) < 2e-3  # N(0, 1e-3)

    jhead = JA.init_mlp_head_params(jax.random.PRNGKey(4), 16, 8, 3)
    head = PA.MLPHead(16, 8, 3, device="cpu")
    head.load_state_dict(mlp_head_state_dict_from_jax(jhead))
    x = np.random.default_rng(4).standard_normal((4, 16)).astype(np.float32)
    with torch.no_grad():
        got = PA.mlp_head(head, _t(x))
    _close(got, JA.mlp_head(jhead, jnp.asarray(x)), 1e-6)
    drawn = PA.init_mlp_head_params(torch.Generator().manual_seed(1), 16, 8, 3)
    assert [tuple(layer.weight.shape) for layer in drawn.layers] == [(8, 16), (3, 8)]


def test_distillation_student_only_step_matches_jax():
    """kd_loss (soft and mixed) against JAX's; the teacher gets no gradient;
    one SGD step: the student equals optax's within 1e-6, the teacher stays
    bit-equal."""
    import jax
    import jax.numpy as jnp
    import optax

    from scail_tpu.models.zoo.gpt import GPTConfig, gpt_forward
    from scail_tpu.training import distill as JD
    from scail_tpu_torch.convert.from_jax import gpt_state_dict_from_jax
    from scail_tpu_torch.models.common import container
    from scail_tpu_torch.training import distill as PD

    jcfg = GPTConfig(**GPT_KW)
    (tparams, teacher), (sparams, student) = _gpt_pair(0), _gpt_pair(1)
    rng = np.random.default_rng(5)
    toks, labels = rng.integers(0, 40, (2, 6)), rng.integers(0, 40, (2, 6))
    z = rng.standard_normal((2, 3, 5)).astype(np.float32)
    z2 = rng.standard_normal((2, 3, 5)).astype(np.float32)
    _close(PD.kd_loss(_t(z), _t(z2)), JD.kd_loss(jnp.asarray(z), jnp.asarray(z2)), 1e-6)
    assert float(PD.kd_loss(_t(z), _t(z))) < 1e-6

    def fwd(p, t):
        return gpt_forward(p, jcfg, t)[0]

    def loss(tree):
        t, s = JD.distill_forward(tree, fwd, fwd, toks)
        return JD.kd_loss(s, t, labels, temperature=2.0, alpha=0.7)

    tree = {"teacher": tparams, "student": sparams}
    jloss, grads = jax.value_and_grad(loss)(tree)
    tx = JD.student_only_optimizer(optax.sgd(0.1))
    updates, _ = tx.update(grads, tx.init(tree), tree)
    new = optax.apply_updates(tree, updates)

    holder = container(teacher=teacher, student=student)
    frozen = _frozen_copy(holder, "student")
    opt = PD.student_only_optimizer(lambda ps: torch.optim.SGD(ps, lr=0.1),
                                    holder.named_parameters())
    t, s = PD.distill_forward(holder, lambda m, x: m(x)[0], lambda m, x: m(x)[0], _t(toks))
    assert not t.requires_grad and s.requires_grad
    val = PD.kd_loss(s, t, _t(labels), temperature=2.0, alpha=0.7)
    _close(val.detach(), jloss, 1e-6)
    val.backward()
    assert all(p.grad is None for p in teacher.parameters())
    opt.step()
    want = gpt_state_dict_from_jax(new["student"])
    for k, v in student.state_dict().items():
        _close(v, want[k], 1e-6)
    for k, v in holder.state_dict().items():
        if k in frozen:
            assert torch.equal(v, frozen[k]), k
