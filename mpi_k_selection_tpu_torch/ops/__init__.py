"""Selection operators: histograms, radix descent, sort."""
