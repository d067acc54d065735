"""Host-side helpers of the port (serialization, synthetic datasets)."""
