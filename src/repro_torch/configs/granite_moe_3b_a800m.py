"""Granite-3.0-3B-A800M MoE [hf:ibm-granite; hf] — 40 experts, top-8."""
from ..models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64, qkv_bias=False,
    moe=MoECfg(n_experts=40, top_k=8, d_ff_expert=512),
    rope_theta=1e4,
)

def smoke():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=32, vocab=256, head_dim=16,
                          moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32),
                          attn_q_chunk=32, loss_chunk=64)
