"""llama-3.2-vision-11b — decoder with cross-attention image layers every 5th
layer (vision frontend STUB: input_specs supplies precomputed patch
embeddings). [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, mlp_act="swiglu",
    cross_every=5, num_image_tokens=1600, rope_theta=5e5,
)
