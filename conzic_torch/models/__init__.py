"""Model towers: BERT masked LM and CLIP."""
