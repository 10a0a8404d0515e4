"""Quality metrics of ANN results."""
