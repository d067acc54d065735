"""Device operations of the port: forest quantization and prediction."""
