"""Evaluation metrics that need weights of their own (LPIPS)."""
