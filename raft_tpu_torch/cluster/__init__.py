"""Clustering: k-means pieces and the balanced IVF trainer."""
