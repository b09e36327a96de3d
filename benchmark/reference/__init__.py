"""The benchmark's plain reference: GF(2^8), the code modes, their stripes."""
