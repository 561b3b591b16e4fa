"""llama3.2-3b [dense]: 28L d=3072 24H (GQA kv=8) ff=8192 vocab=128256."""
from repro_torch.models.config import ModelConfig, dense_pattern


def full():
    return ModelConfig(
        name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=8192, vocab_size=128256, pattern=dense_pattern(),
        rope_theta=500_000.0)


def smoke():
    return ModelConfig(
        name="llama3.2-3b-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=256, vocab_size=512, pattern=dense_pattern(),
        rope_theta=500_000.0, dtype="float32", remat=False)
