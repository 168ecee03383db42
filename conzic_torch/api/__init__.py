"""The entry points: ``demo`` (one image), ``run`` (a directory of images
into the reference's results tree), ``app`` (the web UI) and
``retrieval`` (the CLIP text index and its nearest-caption baseline)."""
