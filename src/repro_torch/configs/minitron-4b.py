"""minitron-4b — pruned nemotron (dense GQA, squared-ReLU).
[arXiv:2407.14679; hf] 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=9216, vocab=256000, mlp_act="sq_relu", rope_theta=1e4,
)
