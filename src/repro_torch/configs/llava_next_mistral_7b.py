"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified] — the anyres vision frontend is a stub: input_specs provides
precomputed patch embeddings concatenated before the text tokens."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128, qkv_bias=False,
    modality="vision_stub", rope_theta=1e6,
)

def smoke():
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=256, head_dim=16,
                          attn_q_chunk=32, loss_chunk=64)
