"""The Event Server: HTTP ingestion of events (counterpart of the JAX
package's ``data/api``)."""
