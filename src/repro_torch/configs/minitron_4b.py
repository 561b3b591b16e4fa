"""minitron-4b [dense]: 32L d=3072 24H (GQA kv=8) ff=9216 vocab=256000
(pruned Nemotron, arXiv:2407.14679)."""
from repro_torch.models.config import ModelConfig, dense_pattern


def full():
    return ModelConfig(
        name="minitron-4b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=9216, vocab_size=256000, pattern=dense_pattern(),
        rope_theta=10_000.0)


def smoke():
    return ModelConfig(
        name="minitron-4b-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=288, vocab_size=512, pattern=dense_pattern(),
        rope_theta=10_000.0, dtype="float32", remat=False)
