"""jamba-v0.1-52b — hybrid Mamba+attention (1:7) with MoE 16e top-2.
[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Superblock of 8: attention at offset 4, mamba elsewhere; MoE on odd layers
(16 MoE layers total). Sub-quadratic (hybrid) -> long_500k runs."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536, mlp_act="swiglu",
    moe_experts=16, moe_top_k=2, moe_every=2, moe_phase=1,
    attn_every=8, attn_offset=4,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    rope_theta=1e4, subquadratic=True,
)
