"""Core library: Thanos, the magnitude baseline and the Alg.-3 driver."""
