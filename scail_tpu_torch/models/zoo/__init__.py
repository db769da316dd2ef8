"""Model zoo (counterpart of scail_tpu/models/zoo/): the decoder LMs,
CogView's cuda2d and the encoders on PyTorch.

Decoders: llama (with its KV cache and the learned KV prefix), mixtral (MoE
over ops/moe.py, expert parallel), gpt (KV cache, `generate`, adapters),
gptneo, glm (GLM-4), chatglm (v1), chatglm23 (v2 / v3), glm130b, glmblock,
cuda2d (2D local attention, ops/local_attn_2d.py).  Encoders: bert (BERT and
RoBERTa), dpr, t5 (encoder-decoder, cached greedy decoding), vit, cait,
eva2, evaclip, glm4v (EVA2-CLIP tokens spliced into GLM-4), mae, yolos.
`common` holds what they share.  Each model takes its released layout
(`*_from_hf` or `*_from_sat`) and the JAX tree through `convert/from_jax.py`
(`lm_state_dict_from_jax` for the decoders, `encoder_state_dict_from_jax`
for the encoders).  The encoders are built on the card unless the caller
passes `device` (the CPU tests pass "cpu"; "meta" then `init_weights_`
draws a large one on its device).  No TPU kernel lies on any of them: their
attention is explicit, with f32 logits and an f32 softmax, as in JAX.
"""
