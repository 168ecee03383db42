"""Host text side (vendored tokenizers, stop masks) and the bridge table."""
