"""Host-side state of the port: the node table and its device snapshot."""
