"""Test and drill helpers of the port (the kill fault of the chaos plane)."""
