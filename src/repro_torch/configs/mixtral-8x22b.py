"""mixtral-8x22b — MoE 8 experts top-2 with sliding-window attention.
[arXiv:2401.04088; hf] 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
SWA window 4096 -> ring-buffer KV cache -> sub-quadratic long_500k decode."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768, mlp_act="swiglu",
    moe_experts=8, moe_top_k=2, moe_every=1,
    window=4096, rope_theta=1e6, subquadratic=True,
)
