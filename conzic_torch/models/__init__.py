"""Model towers: BERT masked LM, CLIP and SigLIP."""
