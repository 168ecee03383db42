"""The Gibbs engine and the Captioner API."""
