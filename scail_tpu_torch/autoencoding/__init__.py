"""autoencoding (scail_tpu_torch): the KL autoencoder of the SD-family image path."""
