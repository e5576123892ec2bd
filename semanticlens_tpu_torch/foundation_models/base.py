"""Abstract vision-language foundation-model protocol.

Counterpart of ``semanticlens_tpu.foundation_models.base``: encode_image,
encode_text, preprocess, tokenize. ``preprocess`` takes a (B, H, W, C) batch
(a tensor on any device or a numpy array) and returns the normalized
(B, H', W', C) float batch on the model's device; the encoders return
L2-unnormalized embeddings.
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class AbstractVLM(ABC):
    """Vision-language foundation model protocol."""

    @abstractmethod
    def encode_image(self, img):
        """(B, H, W, C) preprocessed images → (B, D) embeddings."""

    @abstractmethod
    def encode_text(self, text_input):
        """(B, T) token ids → (B, D) embeddings."""

    @abstractmethod
    def preprocess(self, img):
        """Image batch → device-ready model input."""

    @abstractmethod
    def tokenize(self, txt):
        """String or list of strings → (B, T) token ids."""
