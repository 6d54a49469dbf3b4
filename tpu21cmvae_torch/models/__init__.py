"""The direct emulator and its checkpoint format."""
