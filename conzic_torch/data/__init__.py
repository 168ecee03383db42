"""The procedurally rendered image-caption world of the trained
checkpoints."""
