/* FSG oracle: parse a JSGF file with the reference's compiler and dump
 * the resulting fsg_model_t as text (fsg_model_write) — the weight /
 * topology parity target for the device reimplementation's jsgf.py.
 *
 * Usage: fsg_oracle <file.gram> [lw]
 */
#include <stdio.h>
#include <stdlib.h>
#include <soundswallower/jsgf.h>
#include <soundswallower/fsg_model.h>
#include <soundswallower/logmath.h>

int main(int argc, char *argv[]) {
    jsgf_t *jsgf;
    jsgf_rule_t *rule;
    fsg_model_t *fsg;
    logmath_t *lmath;
    float lw = argc > 2 ? atof(argv[2]) : 6.5f;
    jsgf_rule_iter_t *itor;

    if (argc < 2) {
        fprintf(stderr, "usage: %s <file.gram> [lw]\n", argv[0]);
        return 1;
    }
    jsgf = jsgf_parse_file(argv[1], NULL);
    if (jsgf == NULL) { fprintf(stderr, "parse failed\n"); return 1; }
    rule = NULL;
    for (itor = jsgf_rule_iter(jsgf); itor; itor = jsgf_rule_iter_next(itor)) {
        jsgf_rule_t *r = jsgf_rule_iter_rule(itor);
        if (jsgf_rule_public(r)) { rule = r; jsgf_rule_iter_free(itor); break; }
    }
    if (rule == NULL) { fprintf(stderr, "no public rule\n"); return 1; }
    lmath = logmath_init(1.0001, 0, 0);
    fsg = jsgf_build_fsg(jsgf, rule, lmath, lw);
    fsg_model_write(fsg, stdout);
    return 0;
}
