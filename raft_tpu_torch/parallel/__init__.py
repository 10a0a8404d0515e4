"""Sharded search over a mesh of shards: brute force (``sharded_knn``)
and the IVF-Flat / IVF-PQ families (``sharded_ann``)."""
