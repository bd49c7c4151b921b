"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP patch frontend (STUB:
the caller passes precomputed patch embeddings, ``frontend_embeds``)
[hf:microsoft/Phi-3-vision-128k-instruct]."""
from repro_torch.configs.phi3_mini import CONFIG as _MINI

CONFIG = _MINI.scaled(
    name="phi-3-vision-4.2b",
    frontend="patch",
    frontend_len=576,  # 336px CLIP ViT-L/14 -> 24x24 patches
)
