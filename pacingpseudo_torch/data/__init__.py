"""Host-side data path of the port: slice files, splits, synthetic pools."""
