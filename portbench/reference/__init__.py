"""The plain reference: CaloDiffusion's math in PyTorch and NumPy, importing
nothing of the program under test."""
