"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 backbone with a shared
attention(+MLP) block applied every ``hybrid_period`` layers."""
from ..models.config import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=112, qkv_bias=False,
    ssm=SSMCfg(version=2, state=64, expand=2, conv_width=4, head_dim=64),
    hybrid_period=6, rope_theta=1e4,
)

def smoke():
    return CONFIG.replace(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab=256, head_dim=16,
                          ssm=SSMCfg(version=2, state=4, expand=2,
                                     conv_width=4, head_dim=8),
                          hybrid_period=2, attn_q_chunk=32, loss_chunk=64,
                          ssm_chunk=16)
