"""The plain reference the correctness check holds the program against: float32 PyTorch and Python, importing nothing of the program."""
