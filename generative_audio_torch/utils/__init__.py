"""Device choice and weight conversion."""
