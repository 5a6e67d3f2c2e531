"""Plain torch and numpy references that decide `correct`. They import
nothing of the program (hslam_tpu_torch), of the JAX package or of JAX."""
