"""Dense GQA model on tensors, its registry and the weight converter."""
