"""InternLM2-20B [arXiv:2403.17297; hf] — dense GQA decoder."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544, head_dim=128, qkv_bias=False,
    rope_theta=1e6,
)

def smoke():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=256, head_dim=16,
                          attn_q_chunk=32, loss_chunk=64)
