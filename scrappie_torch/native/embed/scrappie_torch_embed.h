/* Minimal C embed surface for scrappie_torch.
 *
 * The port's analogue of the reference's exported C API
 * (ref interface/scrappie.h:47-52: nanonet_posterior,
 * nanonet_raw_posterior, free_scrappie_matrix): a host application
 * links this shim (and libpython) and drives basecalling and posterior
 * computation over raw float32 signal buffers. The shim embeds the
 * CPython interpreter and routes through scrappie_torch/embed.py, so the
 * C side needs no numpy or torch headers.
 *
 * Device: a torch device name ("cuda", "cuda:1", "cpu"); NULL means the
 * card ("cuda"), where asking for it without one fails.
 *
 * Threading: all calls must come from the thread that called
 * storch_init (the interpreter owns the GIL there). Environment:
 * PYTHONPATH must reach the scrappie_torch package and its dependencies
 * (torch, numpy).
 */
#ifndef SCRAPPIE_TORCH_EMBED_H
#define SCRAPPIE_TORCH_EMBED_H

#ifdef __cplusplus
extern "C" {
#endif

/* Start the interpreter and import scrappie_torch.embed. 0 on success. */
int storch_init(void);

/* Package version string (static storage; do not free). NULL on error. */
const char *storch_version(void);

/* Basecall a raw float32 signal (n samples) with the named model on the
 * named device. Returns a malloc'd NUL-terminated sequence (free with
 * storch_free); NULL on error. score_out may be NULL. */
char *storch_basecall_raw(const float *signal, int n, const char *model,
                          const char *device, float *score_out);

/* Posterior (log space; CRF transitions for rnnrf_r94) of a raw float32
 * signal: malloc'd row-major [*nblock_out x *nstate_out] float32 (free
 * with storch_free); NULL on error. The analogue of the reference's
 * exported posterior calls. */
float *storch_calc_post(const float *signal, int n, const char *model,
                        const char *device, int *nblock_out, int *nstate_out);

void storch_free(void *p);

/* Shut the interpreter down (optional; idempotent). */
void storch_finalize(void);

#ifdef __cplusplus
}
#endif

#endif /* SCRAPPIE_TORCH_EMBED_H */
