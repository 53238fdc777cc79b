"""The port's kernel names, by layer: a device event belongs to a layer
when its name holds one of these as a whole identifier."""

FACTOR = ("gemm_nt", "panel_chol_inv", "trail_offdiag")  # K1
SUBST = ("band_substitute",)                              # K2
ASSEMBLY = ("band_assemble_tiles",)                       # K4, K5
