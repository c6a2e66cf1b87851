/* Oracle dumper: runs the reference SoundSwallower C library and dumps
 * intermediate values (MFCC frames, feature vectors, senone scores,
 * alignment JSON) as raw binary + JSON for parity testing of the device
 * reimplementation.  Test-tooling only; not part of the framework.
 *
 * Usage:
 *   oracle <modeldir> <rawfile> <outdir> [align_text...]
 *
 * Outputs in <outdir>:
 *   mfcc.f32      [n_frames x ncep] float32 cepstra (before CMN)
 *   feat.f32      [n_frames x 39]   float32 features (after CMN/delta/subvec)
 *   senscr.i16    [n_frames x n_sen] int16 senone scores (compallsen mode)
 *   result.json   alignment JSON (align_level=2) if align_text given
 *   segs.txt      word segs from pass-1 FSG search: word sf ef ascr lscr
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <soundswallower/decoder.h>
#include <soundswallower/fe.h>
#include <soundswallower/feat.h>
#include <soundswallower/acmod.h>
#include <soundswallower/configuration.h>
#include <soundswallower/ptm_mgau.h>
#include <soundswallower/state_align_search.h>

static void *read_file(const char *path, size_t *len) {
    FILE *fh = fopen(path, "rb");
    void *data;
    if (fh == NULL) { perror(path); exit(1); }
    fseek(fh, 0, SEEK_END);
    *len = ftell(fh);
    fseek(fh, 0, SEEK_SET);
    data = malloc(*len);
    if (fread(data, 1, *len, fh) != *len) { perror(path); exit(1); }
    fclose(fh);
    return data;
}

int main(int argc, char *argv[]) {
    const char *modeldir, *rawfile, *outdir;
    char path[4096], json[4096];
    config_t *config;
    decoder_t *d;
    int16 *raw;
    size_t raw_len, n_samps;
    FILE *out;
    int i, nfr;

    if (argc < 4) {
        fprintf(stderr, "usage: %s <modeldir> <rawfile> <outdir> [align_text]\n", argv[0]);
        return 1;
    }
    modeldir = argv[1];
    rawfile = argv[2];
    outdir = argv[3];

    if (argc > 5 && argv[5][0] == '{')
        /* extra config fragment: {"key": val, ...} merged after hmm */
        snprintf(json, sizeof(json), "{\"hmm\": \"%s\", %s", modeldir,
                 argv[5] + 1);
    else if (argc > 5)
        snprintf(json, sizeof(json), "{\"hmm\": \"%s\", \"samprate\": %d}",
                 modeldir, atoi(argv[5]));
    else
        snprintf(json, sizeof(json), "{\"hmm\": \"%s\"}", modeldir);
    config = config_parse_json(NULL, json);
    d = decoder_init(config);
    if (d == NULL) { fprintf(stderr, "decoder_init failed\n"); return 1; }

    raw = read_file(rawfile, &raw_len);
    n_samps = raw_len / 2;

    /* Pass A: dump MFCC via acmod's fe directly (mirror
     * acmod_process_full_raw's fe_process + fe_end sequence). */
    {
        fe_t *fe = d->acmod->fe;
        int16 *rp = raw;
        size_t ns = n_samps;
        int ncep = fe_get_output_size(fe);
        mfcc_t **cep;
        int nalloc = fe_process_int16(fe, NULL, &ns, NULL, 0);
        cep = (mfcc_t **)ckd_calloc_2d(nalloc, ncep, sizeof(**cep));
        fe_start(fe);
        nfr = fe_process_int16(fe, &rp, &ns, cep, nalloc);
        nfr += fe_end(fe, cep + nfr, nalloc - nfr);
        snprintf(path, sizeof(path), "%s/mfcc.f32", outdir);
        out = fopen(path, "wb");
        for (i = 0; i < nfr; i++)
            fwrite(cep[i], sizeof(mfcc_t), ncep, out);
        fclose(out);
        printf("mfcc: %d frames x %d\n", nfr, ncep);
        ckd_free_2d(cep);
    }

    /* Pass B: full decode with align text (or <sil> placeholder), dumping
     * features and senone scores. */
    {
        const char *text = (argc > 4 && argv[4][0]) ? argv[4] : NULL;
        int16 *rp = raw;
        int n_sen = d->acmod->mdef ? bin_mdef_n_sen(d->acmod->mdef) : 0;
        FILE *feat_out, *sen_out;

        if (text) {
            if (decoder_set_align_text(d, text) < 0) {
                fprintf(stderr, "set_align_text failed\n");
                return 1;
            }
        }
        decoder_start_utt(d);
        decoder_process_int16(d, raw, n_samps, FALSE, TRUE);
        decoder_end_utt(d);

        /* Exact CMN mean used for this utterance. */
        {
            cmn_t *cm = d->acmod->fcb->cmn_struct;
            snprintf(path, sizeof(path), "%s/cmn_mean.f32", outdir);
            out = fopen(path, "wb");
            fwrite(cm->cmn_mean, sizeof(mfcc_t), cm->veclen, out);
            fclose(out);
        }
        /* Features are retained in the acmod buffer (grow mode). */
        snprintf(path, sizeof(path), "%s/feat.f32", outdir);
        feat_out = fopen(path, "wb");
        acmod_rewind(d->acmod);
        nfr = 0;
        while (d->acmod->n_feat_frame > 0) {
            mfcc_t **frame = acmod_get_frame(d->acmod, NULL);
            int s;
            if (frame == NULL) break;
            /* subvec projected: 3 streams x 13 */
            for (s = 0; s < feat_dimension1(d->acmod->fcb); s++)
                fwrite(frame[s], sizeof(mfcc_t),
                       feat_dimension2(d->acmod->fcb, s), feat_out);
            acmod_advance(d->acmod);
            nfr++;
        }
        fclose(feat_out);
        printf("feat: %d frames\n", nfr);



        {
            /* First-pass word segs (align-text OR grammar decode) */
            seg_iter_t *seg;
            snprintf(path, sizeof(path), "%s/segs.txt", outdir);
            out = fopen(path, "w");
            for (seg = decoder_seg_iter(d); seg; seg = seg_iter_next(seg)) {
                int sf, ef;
                int32 ascr, lscr;
                seg_iter_frames(seg, &sf, &ef);
                seg_iter_prob(seg, &ascr, &lscr);
                fprintf(out, "%s %d %d %d %d\n", seg_iter_word(seg),
                        sf, ef, ascr, lscr);
            }
            fclose(out);
            printf("hyp: %s\n", decoder_hyp(d, NULL));
        }
        if (text) {
            const char *jsonres;
            /* Pass-2 per-frame senone scores: replicate decoder_alignment's
             * loop manually so we can dump acmod_score output. */
            {
                alignment_t *al = alignment_init(d->d2p);
                search_module_t *align;
                frame_idx_t ofr = d->acmod->output_frame;
                FILE *p2;
                seg_iter_t *s2;
                int prev_ef = -1;
                for (s2 = decoder_seg_iter(d); s2; s2 = seg_iter_next(s2)) {
                    int32 wid2 = dict_wordid(d->dict, s2->word);
                    if (wid2 != BAD_S3WID) {
                        prev_ef = s2->ef;
                        alignment_add_word(al, wid2, s2->sf, s2->ef - s2->sf + 1);
                    }
                }
                alignment_populate(al);
                align = state_align_search_init("_sa", d->config, d->acmod, al);
                acmod_rewind(d->acmod);
                search_module_start(align);
                snprintf(path, sizeof(path), "%s/senscr_pass2.i16", outdir);
                p2 = fopen(path, "wb");
                while (d->acmod->output_frame < ofr) {
                    /* mirror state_align_search_step's activation + score */
                    int fi = d->acmod->output_frame;
                    state_align_search_t *sas = (state_align_search_t *)align;
                    int16 const *scr;
                    int i2;
                    for (i2 = 0; i2 < sas->n_phones; ++i2)
                        if (hmm_frame(&sas->hmms[i2]) == fi)
                            acmod_activate_hmm(d->acmod, &sas->hmms[i2]);
                    scr = acmod_score(d->acmod, &fi);
                    fwrite(scr, sizeof(int16), n_sen, p2);
                    fwrite(&d->acmod->n_senone_active, sizeof(int32), 1, p2);
                    /* now run the actual step (re-scores via memoized
                     * senscr_frame? no: not compallsen, so it re-evaluates
                     * -- but with the same active list, giving identical
                     * results and identical state evolution) */
                    search_module_step(align, d->acmod->output_frame);
                    acmod_advance(d->acmod);
                }
                fclose(p2);
                search_module_finish(align);
                /* Install as the decoder's alignment so result_json
                 * reuses it instead of re-running (keeps scorer state
                 * identical to the plain decode->align sequence). */
                d->align = align;
                (void)prev_ef;
            }
            /* Two-pass alignment JSON */
            jsonres = decoder_result_json(d, 0.0, 2);
            snprintf(path, sizeof(path), "%s/result.json", outdir);
            out = fopen(path, "w");
            if (jsonres) fputs(jsonres, out);
            fclose(out);
            printf("hyp: %s\n", decoder_hyp(d, NULL));
        }

        /* Senone scores in compallsen mode over the same features.
         * ALSO dump the internal PTM top-N state per frame (cw int32 +
         * normalized score int32 per [cb][feat][topn]) for debugging. */
        acmod_rewind(d->acmod);
        d->acmod->compallsen = TRUE;
        /* Reset the fast history so this pass starts from pristine seeds
         * (decoupled from the pass above). */
        snprintf(path, sizeof(path), "%s/senscr.i16", outdir);
        sen_out = fopen(path, "wb");
        {
            /* The topn state dump is PTM-specific (the cast below is
             * invalid for the s2_semi/ms scorers, which have different
             * struct layouts); senscr.i16 is backend-independent. */
            FILE *topn_out;
            int is_ptm =
                strcmp(ps_mgau_base(d->acmod->mgau)->vt->name, "ptm") == 0;
            ptm_mgau_t *pm = is_ptm ? (ptm_mgau_t *)d->acmod->mgau : NULL;
            int n_mgau = pm ? pm->g->n_mgau : 0,
                n_feat = pm ? pm->g->n_feat : 0,
                max_topn = pm ? pm->max_topn : 0;
            snprintf(path, sizeof(path), "%s/topn.i32", outdir);
            topn_out = fopen(path, "wb");
            nfr = 0;
            while (d->acmod->n_feat_frame > 0) {
                int frame_idx = d->acmod->output_frame;
                int16 const *scr = acmod_score(d->acmod, &frame_idx);
                int cb, f, k;
                if (scr == NULL) break;
                fwrite(scr, sizeof(int16), n_sen, sen_out);
                if (pm)
                    for (cb = 0; cb < n_mgau; cb++)
                        for (f = 0; f < n_feat; f++)
                            for (k = 0; k < max_topn; k++) {
                                int32 v[2];
                                v[0] = pm->f->topn[cb][f][k].cw;
                                v[1] = pm->f->topn[cb][f][k].score;
                                fwrite(v, sizeof(int32), 2, topn_out);
                            }
                acmod_advance(d->acmod);
                nfr++;
            }
            fclose(topn_out);
        }
        fclose(sen_out);
        d->acmod->compallsen = FALSE;
        printf("senscr: %d frames x %d\n", nfr, n_sen);

    }

    decoder_free(d);
    free(raw);
    return 0;
}
