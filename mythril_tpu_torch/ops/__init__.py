"""Word arithmetic and hashing over PyTorch tensors (u256 limbs, keccak)."""
