"""HTTP front end (JSON and protobuf), the wire codecs and the internal client."""
