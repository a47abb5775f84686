"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-235B-A22B; hf] — 128 experts, top-8,
GQA kv=4. d_ff below is the per-expert intermediate width."""
from ..models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=128, qkv_bias=False,
    moe=MoECfg(n_experts=128, top_k=8, d_ff_expert=1536),
    rope_theta=1e6,
)

def smoke():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=32, vocab=256, head_dim=16,
                          moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32),
                          attn_q_chunk=32, loss_chunk=64)
