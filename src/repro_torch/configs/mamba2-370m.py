"""mamba2-370m — attention-free SSM (SSD, state-space duality).
[arXiv:2405.21060; unverified] 48L d_model=1024 d_ff=0 vocab=50280
ssm_state=128. O(1)-state decode -> long_500k runs."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=0, vocab=50280, attn_every=0,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    subquadratic=True,
)
