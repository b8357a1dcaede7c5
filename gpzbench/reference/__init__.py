"""The benchmark's plain reference of GPz (gpz.py) and of its optimizer
(lbfgs.py): plain PyTorch and NumPy, importing nothing of the program."""
