"""seamless-m4t-medium — encoder-decoder, multimodal (audio frontend STUB:
input_specs supplies precomputed frame embeddings, per the assignment).
[arXiv:2308.11596; hf] 12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
Built as 12 encoder + 12 decoder layers (per-stack depth)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, enc_layers=12, d_model=1024, num_heads=16,
    num_kv_heads=16, head_dim=64, d_ff=4096, vocab=256206, mlp_act="gelu",
    cross_every=1, num_audio_frames=1024, rope_theta=1e4,
)
