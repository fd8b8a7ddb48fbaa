"""The benchmark's plain reference: the models' forward pass, loss and
gradients (``model.py``) and the delta-stale AdamW steps (``train.py``)
in plain PyTorch, independent of the program under test."""
