"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) ff=24576
vocab=65536, Mamba+attention 1:7 interleave, MoE 16e top-2 every other
layer (arXiv:2403.19887). No explicit positional encoding (Mamba provides
position)."""
from repro_torch.models.config import ModelConfig, jamba_pattern


def full():
    return ModelConfig(
        name="jamba-1.5-large", n_layers=72, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=24576, vocab_size=65536, pattern=jamba_pattern(),
        n_experts=16, experts_per_token=2, ssm_state=16, ssm_conv=4,
        ssm_expand=2, pos="none", fsdp=True)


def smoke():
    return ModelConfig(
        name="jamba-smoke", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, pattern=jamba_pattern(), n_experts=4,
        experts_per_token=2, ssm_state=8, capacity_factor=2.0, pos="none",
        dtype="float32", remat=False)
