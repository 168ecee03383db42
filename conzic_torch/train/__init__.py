"""Training: the trainer of the tiny semantic checkpoints
(``python -m conzic_torch.train.tiny``) and its optimizer."""
