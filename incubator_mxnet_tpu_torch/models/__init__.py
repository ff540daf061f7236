"""Models of the PyTorch port."""
from .bert import (BERTForPretrain, BERTMLMOnly, BERTModel,
                   BERTPretrainLoss, bert_base, bert_large, bert_tiny)
from .gpt import GPTCell, GPTModel, gpt2_124m, gpt_tiny

__all__ = ["GPTCell", "GPTModel", "gpt_tiny", "gpt2_124m", "BERTModel",
           "BERTForPretrain", "BERTPretrainLoss", "BERTMLMOnly", "bert_tiny",
           "bert_base", "bert_large"]
