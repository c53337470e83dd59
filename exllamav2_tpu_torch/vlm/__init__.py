"""Vision-language models: vision towers, multimodal embeddings and image
preprocessing (PyTorch port of exllamav2_tpu/vlm)."""

from exllamav2_tpu_torch.vlm.mm_embedding import MMEmbedding
from exllamav2_tpu_torch.vlm.vision_tower import VisionTower

__all__ = ["VisionTower", "MMEmbedding"]
