"""Host and device data conventions shared by the host loops."""
