"""Host streaming: background decode overlapping device compute."""
