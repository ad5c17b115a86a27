"""HTTP serving of the video predictor: the session API (InferenceAPI), a
GraphQL subset of the reference demo's schema, the stdlib server, the
single-page frontend and upload transcoding."""
