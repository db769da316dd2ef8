"""Model zoo (counterpart of scail_tpu/models/zoo/): the decoder LMs and
CogView's cuda2d on PyTorch.

Ported: llama (with its KV cache and the learned KV prefix), mixtral (MoE
over ops/moe.py, expert parallel), gpt (KV cache, `generate`), gptneo, glm
(GLM-4), chatglm (v1), chatglm23 (v2 / v3), glm130b, glmblock, cuda2d (2D
local attention, ops/local_attn_2d.py); `common` holds what they share.
Each model takes its released layout (`*_from_hf` or `*_from_sat`) and the
JAX tree through `convert/from_jax.py` `lm_state_dict_from_jax`.  The
encoder half of the JAX zoo (t5, bert, dpr, vit, cait, eva2, evaclip,
glm4v, mae, yolos) is not ported yet (ROADMAP Queue 1).
"""
