"""The unfolded AlignNet model in PyTorch (PointNet branch)."""
