"""Test helpers of the port: an in-process mock Kafka broker."""
