"""PENet depth completion and virtual-point generation."""
