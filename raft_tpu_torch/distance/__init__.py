"""Distance metric types and fused L2 + argmin."""
