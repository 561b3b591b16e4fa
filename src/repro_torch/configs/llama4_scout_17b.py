"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) expert-ff=8192
vocab=202048, MoE 16 experts top-1 + 1 shared, every layer (~109B total,
17B active)."""
from repro_torch.models.config import ModelConfig, dense_pattern


def full():
    return ModelConfig(
        name="llama4-scout-17b", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=8192, vocab_size=202048,
        pattern=dense_pattern(moe_every=1), n_experts=16,
        experts_per_token=1, n_shared_experts=1, rope_theta=500_000.0,
        fsdp=True)


def smoke():
    return ModelConfig(
        name="llama4-scout-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512,
        pattern=dense_pattern(moe_every=1), n_experts=4,
        experts_per_token=1, n_shared_experts=1, capacity_factor=2.0,
        dtype="float32", remat=False)
