"""minicpm3-4b [dense]: 62L d=2560 40H (kv=40 -> MHA) ff=6400 vocab=73448.

The original model is MLA; the assigned config line pins 40 full KV heads,
so we implement the assigned numbers (see DESIGN.md §4)."""
from repro_torch.models.config import ModelConfig, dense_pattern


def full():
    return ModelConfig(
        name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40,
        n_kv_heads=40, d_ff=6400, vocab_size=73448, pattern=dense_pattern(),
        rope_theta=10_000.0)


def smoke():
    return ModelConfig(
        name="minicpm3-4b-smoke", n_layers=2, d_model=80, n_heads=4,
        n_kv_heads=4, d_ff=192, vocab_size=512, pattern=dense_pattern(),
        dtype="float32", remat=False)
