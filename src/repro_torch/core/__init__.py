"""Core numerics: quantization, Table-I decomposition, precision policy."""
