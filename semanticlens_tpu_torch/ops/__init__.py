"""Device ops: preprocessing, aggregation, streaming top-k, k-means, the cosine kernel."""
