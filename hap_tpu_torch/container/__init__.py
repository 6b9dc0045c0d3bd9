"""Host-side Hap container parsing, independent of the device path."""
