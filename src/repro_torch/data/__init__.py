"""Synthetic datasets with planted ground truth, and the randomized block
layout the sampling policies read."""
