"""Host-side utilities of the port: image and style-matrix IO."""
