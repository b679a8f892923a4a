"""Plain tensor ops and the attention cores."""
