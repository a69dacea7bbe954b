"""nemotron-4-15b — dense GQA with squared-ReLU MLP.
[arXiv:2402.16819; unverified] 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=256000, mlp_act="sq_relu", rope_theta=1e4,
)
