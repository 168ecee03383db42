"""The command-line entry points: ``demo`` (one image) and ``run`` (a
directory of images into the reference's results tree)."""
