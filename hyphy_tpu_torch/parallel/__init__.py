"""The device mesh: which device computes which patterns and which items."""
