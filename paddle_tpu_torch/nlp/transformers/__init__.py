"""Transformer model families ported so far: GPT."""

from .gpt import (  # noqa: F401
    GPTConfig, GPTForPretraining, GPTModel, gpt_config,
)
