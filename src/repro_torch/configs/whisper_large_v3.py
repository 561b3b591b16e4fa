"""whisper-large-v3 [audio]: enc-dec, 32L d=1280 20H (kv=20) ff=5120
vocab=51866. Conv/mel frontend is a STUB: the caller feeds precomputed
1500-frame embeddings to the encoder; the assigned shapes parameterize the
DECODER token stream."""
from repro_torch.models.config import ModelConfig, dense_pattern


def full():
    return ModelConfig(
        name="whisper-large-v3", n_layers=32, d_model=1280, n_heads=20,
        n_kv_heads=20, d_ff=5120, vocab_size=51866, pattern=dense_pattern(),
        encoder_layers=32, encoder_seq=1500, frontend="audio",
        pos="sinusoidal")


def smoke():
    return ModelConfig(
        name="whisper-large-v3-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=512, pattern=dense_pattern(),
        encoder_layers=2, encoder_seq=30, frontend="audio",
        pos="sinusoidal", dtype="float32", remat=False)
