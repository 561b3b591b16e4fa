"""codeqwen1.5-7b [dense]: 32L d=4096 32H (kv=32 -> MHA) ff=13440 vocab=92416."""
from repro_torch.models.config import ModelConfig, dense_pattern


def full():
    return ModelConfig(
        name="codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=32, d_ff=13440, vocab_size=92416, pattern=dense_pattern(),
        rope_theta=1_000_000.0)


def smoke():
    return ModelConfig(
        name="codeqwen1.5-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=192, vocab_size=512, pattern=dense_pattern(),
        dtype="float32", remat=False)
