"""Falcon-Mamba-7B [arXiv:2410.05355; unverified] — pure Mamba1, attn-free.
The long_500k cell runs here (O(1) state, sub-quadratic by construction)."""
from ..models.config import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024, head_dim=64, qkv_bias=False,
    ssm=SSMCfg(version=1, state=16, expand=2, conv_width=4),
)

def smoke():
    return CONFIG.replace(n_layers=2, d_model=64, vocab=256,
                          ssm=SSMCfg(version=1, state=4, expand=2,
                                     conv_width=4),
                          loss_chunk=64, ssm_chunk=16)
