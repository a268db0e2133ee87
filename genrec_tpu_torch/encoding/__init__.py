"""Text and student encoders of the port: the weight-free paths of the JAX
package's ``encoding/`` (hashing embeddings in place of BERT's)."""
