"""xlstm-125m [ssm]: 12L d=768 4H vocab=50304, mLSTM+sLSTM blocks (3:1
interleave; the paper's 7:1 doesn't divide 12 layers — DESIGN.md §4),
no separate FFN (d_ff=0)."""
from repro_torch.models.config import ModelConfig, xlstm_pattern


def full():
    return ModelConfig(
        name="xlstm-125m", n_layers=12, d_model=768, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab_size=50304, pattern=xlstm_pattern(),
        mlstm_expand=2, pos="none", tie_embeddings=True)


def smoke():
    return ModelConfig(
        name="xlstm-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=512, pattern=xlstm_pattern(), mlstm_expand=2,
        pos="none", tie_embeddings=True, dtype="float32", remat=False)
