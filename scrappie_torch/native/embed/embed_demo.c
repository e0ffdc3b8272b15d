/* Demo and test program for the C embed surface.
 *
 * Usage: embed_demo <signal.f32> [model] [device]
 * Reads a raw little-endian float32 signal file, basecalls it through
 * storch_basecall_raw, prints "<score> <sequence>" on stdout, and checks
 * that storch_calc_post returns a matrix, whose shape it prints on stderr
 * ("post NBLOCK x NSTATE"). No device argument means the card.
 */
#include <stdio.h>
#include <stdlib.h>

#include "scrappie_torch_embed.h"

int main(int argc, char **argv) {
    if (argc < 2) {
        fprintf(stderr, "usage: %s signal.f32 [model] [device]\n", argv[0]);
        return 2;
    }
    const char *model = argc > 2 ? argv[2] : "rgrgr_r94";
    const char *device = argc > 3 ? argv[3] : NULL;

    FILE *fh = fopen(argv[1], "rb");
    if (fh == NULL) {
        perror("fopen");
        return 2;
    }
    fseek(fh, 0, SEEK_END);
    long nbytes = ftell(fh);
    fseek(fh, 0, SEEK_SET);
    int n = (int)(nbytes / (long)sizeof(float));
    float *sig = malloc(nbytes > 0 ? (size_t)nbytes : 1);
    if (sig == NULL || fread(sig, sizeof(float), (size_t)n, fh) != (size_t)n) {
        fprintf(stderr, "short read\n");
        fclose(fh);
        free(sig);
        return 2;
    }
    fclose(fh);

    if (storch_init() != 0) {
        fprintf(stderr, "storch_init failed\n");
        free(sig);
        return 1;
    }
    const char *ver = storch_version();
    fprintf(stderr, "scrappie_torch %s\n", ver ? ver : "?");

    float score = 0.0f;
    char *seq = storch_basecall_raw(sig, n, model, device, &score);
    if (seq == NULL) {
        fprintf(stderr, "basecall failed\n");
        free(sig);
        return 1;
    }

    int nblock = 0, nstate = 0;
    float *post = storch_calc_post(sig, n, model, device, &nblock, &nstate);
    if (post == NULL || nblock <= 0 || nstate <= 0) {
        fprintf(stderr, "calc_post failed\n");
        free(sig);
        return 1;
    }
    fprintf(stderr, "post %d x %d\n", nblock, nstate);
    storch_free(post);

    printf("%.4f %s\n", score, seq);
    storch_free(seq);
    storch_finalize();
    free(sig);
    return 0;
}
