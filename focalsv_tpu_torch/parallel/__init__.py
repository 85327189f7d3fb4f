"""Device mesh, region-batch sharding, and collective gather of SV records."""
