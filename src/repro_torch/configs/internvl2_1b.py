"""internvl2-1b [vlm]: 24L d=896 14H (GQA kv=2) ff=4864 vocab=151655.
InternViT frontend is a STUB: input_specs provides precomputed patch
embeddings prepended to the token stream."""
from repro_torch.models.config import ModelConfig, dense_pattern


def full():
    return ModelConfig(
        name="internvl2-1b", n_layers=24, d_model=896, n_heads=14,
        n_kv_heads=2, d_ff=4864, vocab_size=151655, pattern=dense_pattern(),
        frontend="vision", vision_tokens=256, rope_theta=1_000_000.0)


def smoke():
    return ModelConfig(
        name="internvl2-1b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512, pattern=dense_pattern(),
        frontend="vision", vision_tokens=8, dtype="float32", remat=False)
