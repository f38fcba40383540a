"""Transformer model families ported so far: GPT, ERNIE / BERT."""

from .ernie import (  # noqa: F401
    BertConfig, BertForPretraining, BertModel, BertPretrainingCriterion,
    ErnieConfig, ErnieForPretraining, ErnieForSequenceClassification,
    ErnieModel, ErniePretrainingCriterion,
    bert_config, ernie_config,
)
from .gpt import (  # noqa: F401
    GPTConfig, GPTForPretraining, GPTModel, GPTPretrainingCriterion,
    gpt_config,
)
