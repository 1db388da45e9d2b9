"""Models: the flagship transformer LM and the zoo (MLP, ResNet, ViT, BERT,
seq2seq, the MoE feed-forward), their registry, weight import from the JAX
package and from HF Llama checkpoints, and dense-KV-cache generation."""

from .convert_hf import from_hf_llama, merge_lora, to_hf_llama_state_dict
from .registry import ModelBundle, build_model, registered_models

__all__ = ["ModelBundle", "build_model", "from_hf_llama", "merge_lora",
           "registered_models", "to_hf_llama_state_dict"]
