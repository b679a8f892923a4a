"""ResNet-50-DC5 backbone, AnchorDETR transformer and the counting model."""
