"""The unfolded AlignNet model in PyTorch (PointNet and DGCNN backbones)."""
