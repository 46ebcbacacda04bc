"""Host-side DSP design helpers of the port (numpy, float64-built)."""
