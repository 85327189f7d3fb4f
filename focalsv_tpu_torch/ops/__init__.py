"""Device-side compute primitives: encoding, alignment DP, clustering, consensus."""
