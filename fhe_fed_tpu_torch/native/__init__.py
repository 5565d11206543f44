"""Host-side native code of the port (the Paillier bignum kernels)."""
