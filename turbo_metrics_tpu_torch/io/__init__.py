"""Host-side input: probing and Y4M reading."""
